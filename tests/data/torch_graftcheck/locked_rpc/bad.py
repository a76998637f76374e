import threading
import urllib.request


class A:
    def __init__(self):
        self._l = threading.Lock()

    def locked_rpc(self):
        with self._l:
            urllib.request.urlopen("http://example/x")

    def unlocked_rpc(self):
        urllib.request.urlopen("http://example/x", timeout=1.0)
