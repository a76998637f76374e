import urllib.request


class Node:
    def naked(self, w):
        return urllib.request.urlopen(w + "/worker/thing")

    def wrapped(self, w):
        def rpc():
            return urllib.request.urlopen(w + "/worker/thing")
        return self.resilience.worker_call(w, rpc)

    def wrapped_lambda(self, w):
        return self.resilience.worker_call(
            w, lambda: urllib.request.urlopen(w))

    def kw_wrapped(self, w):
        def rpc():
            return urllib.request.urlopen(w)
        return self.resilience.worker_call(w, fn=rpc)

    def _gather(self, queries, rpc_one, deadline):
        def call(addr):
            return self.resilience.worker_call(
                addr, lambda: rpc_one(addr, deadline))
        return [call(w) for w in self.workers]

    def scatter(self, queries):
        def rpc_one(addr, deadline):
            return urllib.request.urlopen(addr + "/worker/process")
        return self._gather(queries, rpc_one, 1.0)

    def naked_failover(self, backup, names):
        def slice_rpc():
            return urllib.request.urlopen(backup + "/worker/slice")
        return slice_rpc()
