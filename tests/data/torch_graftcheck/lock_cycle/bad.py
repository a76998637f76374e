import threading


class A:
    def __init__(self):
        self._l1 = threading.Lock()
        self._l2 = threading.Lock()

    def ab(self):
        with self._l1:
            with self._l2:
                pass

    def ba(self):
        with self._l2:
            with self._l1:
                pass
