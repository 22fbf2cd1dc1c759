"""fasthevc_tpu_torch stands alone: it imports neither the JAX package nor
JAX, and its copies of the host layers equal their originals.

The port keeps verbatim copies of the JAX package's host layers (`spec/`,
`config/`, `utils/`, `codec/gop.py`, `codec/rate_control.py`,
`codec/journal.py` and the C++ entropy engine `cabac_cpp/`), so a fix to
one of them is made in both packages; these tests fail when the two drift
apart.
"""

import ast
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "fasthevc_tpu_torch")
REF = os.path.join(REPO, "fasthevc_tpu")
BANNED = ("fasthevc_tpu", "jax", "flax", "optax")
COPIED_DIRS = ("spec", "config", "utils")
COPIED_CODEC = ("gop.py", "rate_control.py", "journal.py")
CPP_SOURCES = ("cabac.cpp", "slice_engine.cpp", "sanitize_main.cpp")


def _port_modules():
    """Every .py file of the port, and chip_smoke.py."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_tops(path):
    """Top-level names of the absolute imports in a module."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_the_jax_package_or_jax():
    bad = {os.path.relpath(p, REPO): sorted(_imported_tops(p) & set(BANNED))
           for p in _port_modules()}
    assert not {k: v for k, v in bad.items() if v}


def test_every_port_module_imports_with_both_names_refused():
    """A meta-path hook refuses the top-level names `fasthevc_tpu` and `jax`
    (exactly: `fasthevc_tpu_torch` stays allowed), then every module of the
    port is imported."""
    mods = []
    for p in _port_modules():
        rel = os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
        if rel == "chip_smoke":
            continue
        mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__")
                    else rel)
    code = f"""
import importlib, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BANNED!r}:
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
for m in {mods!r}:
    importlib.import_module(m)
import chip_smoke
print("imported", len({mods!r}) + 1)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"imported {len(mods) + 1}" in proc.stdout


def test_copied_cpp_sources_equal_the_originals():
    for name in CPP_SOURCES:
        assert filecmp.cmp(os.path.join(REF, "cabac_cpp", name),
                           os.path.join(PORT, "cabac_cpp", name),
                           shallow=False), name


def _python_files(top):
    out = []
    for root, _, names in os.walk(top):
        out += [os.path.relpath(os.path.join(root, n), top) for n in names
                if n.endswith(".py")]
    return sorted(out)


def test_copied_python_modules_equal_the_originals():
    """spec/, config/, utils/, codec/gop.py, codec/rate_control.py and
    codec/journal.py byte for byte (cabac_cpp's __init__.py differs in its
    build location only), and synthesize_yuv makes the same frames from both packages."""
    for d in COPIED_DIRS:
        ref_files = _python_files(os.path.join(REF, d))
        assert ref_files == _python_files(os.path.join(PORT, d)), d
        for rel in ref_files:
            assert filecmp.cmp(os.path.join(REF, d, rel),
                               os.path.join(PORT, d, rel),
                               shallow=False), f"{d}/{rel}"
    for name in COPIED_CODEC:
        assert filecmp.cmp(os.path.join(REF, "codec", name),
                           os.path.join(PORT, "codec", name),
                           shallow=False), f"codec/{name}"
    from fasthevc_tpu.utils import synthesize_yuv as ref_synth
    from fasthevc_tpu_torch.utils import synthesize_yuv as port_synth
    for a, b in zip(ref_synth(96, 64, 3, seed=11),
                    port_synth(96, 64, 3, seed=11)):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("name", ["libfasthevc_cabac"])
def test_cabac_engine_builds_under_build_dir(name):
    """The port's C++ engine is built into build/fasthevc_tpu_torch/,
    keyed by a hash of its sources, never next to them."""
    from fasthevc_tpu_torch import cabac_cpp
    so = cabac_cpp._SO
    assert os.path.dirname(so) == os.path.join(REPO, "build",
                                               "fasthevc_tpu_torch")
    assert os.path.basename(so).startswith(name + "_")
    if cabac_cpp.available():
        assert os.path.exists(so)
    assert not any(f.endswith(".so")
                   for f in os.listdir(os.path.join(PORT, "cabac_cpp")))
