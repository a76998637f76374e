"""With none of the plugin's variables set nothing is instrumented:
the port's modules hold the real ``threading`` and ``np``, the tensor
methods and the handler classes are their own."""

import importlib
import threading

import numpy as np
import torch


def test_nothing_installed():
    from tfidf_tpu_torch.tools.graftcheck import pytest_witness as pw
    names = pw.import_port()
    from tfidf_tpu_torch.cluster import coordination, router
    assert len(names) > 20
    for name in names:
        mod = importlib.import_module(name)
        assert mod.__dict__.get("threading", threading) is threading, name
        assert mod.__dict__.get("np", np) is np, name
    for attr in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__"):
        code = getattr(torch.Tensor.__dict__.get(attr), "__code__", None)
        assert code is None or "graftcheck" not in code.co_filename, attr
    for cls in (router._HttpHandlerBase, coordination._CoordHandler):
        for attr in ("send_response", "send_header", "end_headers"):
            assert "Witness" not in getattr(cls, attr).__qualname__
    assert not pw._RAN
    assert not pw.write_child_hook(".")
