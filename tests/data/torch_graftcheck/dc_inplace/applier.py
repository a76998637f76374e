import torch


class Applier:
    def apply(self, df: torch.Tensor) -> torch.Tensor:
        return df.index_add(0, torch.zeros(1, dtype=torch.long),
                            torch.ones(1))

    def describe(self, df: torch.Tensor) -> str:
        return str(df.shape)
