import torch

from tfidf_tpu_torch.applier import Applier


class Index:
    def __init__(self):
        self._app = Applier()
        self._df = torch.zeros(8)
        self.snapshot = None

    def commit(self):
        new = self._app.apply(self._df)
        self._df = new
        return new

    def commit_rebind_same_line(self, df):
        df = self._app.apply(df)
        return df

    def keep(self):
        out = self._app.apply(self._df)
        return out

    def host_result(self):
        text = self._app.describe(self._df)
        self._df = torch.zeros(8)
        return text
