from tfidf_tpu_torch.ops.ell import launch, launch_raw, launch_rebuilding


class Searcher:
    def seam(self, x):
        return launch(x)

    def rebuild(self, x):
        return launch_rebuilding(x)

    def raw(self, x):
        return launch_raw(x)
