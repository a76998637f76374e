import os
import threading


class Store:
    def __init__(self):
        self._mu = threading.Lock()

    def flush(self, fd):
        with self._mu:
            pass

    def sync(self, fd):
        os.fsync(fd)


class A:
    def __init__(self, store: Store):
        self._l = threading.Lock()
        self.store = store

    def locked_sync(self):
        with self._l:
            self.store.sync(1)

    def nested(self):
        with self._l:
            self.store.flush(1)
