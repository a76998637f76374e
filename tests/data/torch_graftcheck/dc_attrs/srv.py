from tfidf_tpu_torch.snapmod import Snap


class Searcher:
    def device_attr(self, snap: Snap, k):
        n = float(snap.n_docs)
        return n * k

    def optional_device_attr(self, snap: Snap):
        return snap.df.tolist()

    def host_attr(self, snap: Snap):
        live = snap.block_live.tolist()
        return live, int(snap.version), snap.block_live.nonzero()
