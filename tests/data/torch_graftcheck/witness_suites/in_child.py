"""Child coverage: the clean module of the session's witness runs in a
child ``python`` with the child hook first on its ``PYTHONPATH``; the
session itself observes nothing, so it passes only if the child's report
is merged."""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = HERE
for _ in range(4):
    ROOT = os.path.dirname(ROOT)


def test_clean_module_in_a_child(tmp_path):
    from tfidf_tpu_torch.tools.graftcheck import pytest_witness as pw
    name = next(n for n in pw.CHILD_WITNESSES if pw.enabled(n))
    stub = tmp_path / "stub"
    stub.mkdir()
    assert pw.write_child_hook(stub)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(stub), ROOT]))
    r = subprocess.run(
        [sys.executable, "-m", "pytest", os.path.join(HERE, f"{name}_clean.py"),
         "-q", "--noconftest", "-p", "no:cacheprovider", "-p", "no:xdist"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
