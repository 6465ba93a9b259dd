"""The port stands alone: no module of pfnl_tpu_torch and no line of
chip_smoke.py imports the JAX package, jax or flax (read with `ast`, so a
lazy import inside a function counts too), and the port's own PNG reader
and writer give the same bytes on disk and the same arrays back as the
JAX package's utils/image_io.py."""

import ast
import glob
import os

import numpy as np
import pytest

from pfnl_tpu.utils import image_io as jimage_io

from pfnl_tpu_torch.utils import image_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("pfnl_tpu", "jax", "jaxlib", "flax")
SOURCES = sorted(glob.glob(os.path.join(ROOT, "pfnl_tpu_torch", "**", "*.py"), recursive=True)
                 + [os.path.join(ROOT, "chip_smoke.py")])


def _imported(path):
    """Every top-level package name that `path` imports, anywhere in it."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_nothing_of_jax(path):
    bad = _imported(path) & set(FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {sorted(bad)}"


def test_the_checker_sees_a_lazy_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import numpy\n\ndef f():\n    from pfnl_tpu.utils.image_io import imread\n")
    assert _imported(str(p)) == {"numpy", "pfnl_tpu"}


@pytest.mark.parametrize("shape", [(7, 9, 3), (5, 6)])
def test_png_round_trip_matches_the_jax_package(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    image_io.imsave(ours, img)
    jimage_io.imsave(theirs, img)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for reader in (image_io.imread, jimage_io.imread):
        np.testing.assert_array_equal(reader(ours), img)
    np.testing.assert_array_equal(image_io.imread(theirs), jimage_io.imread(theirs))


def test_imsave_raises_where_cv2_fails_silently(tmp_path):
    with pytest.raises(IOError):
        image_io.imsave(str(tmp_path / "missing" / "x.png"), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(FileNotFoundError):
        image_io.imread(str(tmp_path / "none.png"))
