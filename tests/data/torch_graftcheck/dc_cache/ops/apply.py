import functools

import torch

from tfidf_tpu_torch.ops.csr import next_capacity


def body(x):
    return x + 1


def hot_path(xs):
    fn = torch.compile(body)
    return fn(xs)


class Memo:
    def __init__(self):
        self._fns = {}
        self._bufs = {}

    def get_fn(self, xs):
        cap = next_capacity(xs.shape[0], 8)
        fn = self._fns.get(cap)
        if fn is None:
            fn = torch.compile(body)
            self._fns[cap] = fn
        return fn

    def get_fn_by_size(self, xs):
        n = xs.shape[0]
        fn = self._fns.get(n)
        if fn is None:
            fn = torch.compile(body)
            self._fns[n] = fn
        return fn

    def buffer_by_capacity(self, snap, batch):
        cap = next_capacity(snap.n_docs, 1024)
        key = (min(batch, 512), cap)
        if key not in self._bufs:
            self._bufs[key] = torch.empty((batch, cap))
        return self._bufs[key]

    def buffer_by_docs(self, snap, batch):
        key = (batch, snap.n_docs)
        return self._bufs.setdefault(key, torch.zeros((batch, snap.n_docs)))


def make_search(k):
    def search(x):
        return torch.topk(x, k)
    return torch.compile(search)


@functools.lru_cache(maxsize=None)
def cached_factory(k):
    return torch.compile(body)
