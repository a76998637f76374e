import os

import numpy as np


class Saver:
    def save(self, path, data, arrays):
        with open(path + ".tmp", "wb") as f:
            f.write(data)
        np.savez(path + ".npz", **arrays)
        os.replace(path + ".tmp", path)

    def load(self, path):
        with open(path, "rb") as f:
            return f.read()
