"""The port's plain ops and its copied numpy helpers against the JAX
package's, on the CPU."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.ops import degrade as jdegrade
from pfnl_tpu.ops import resize as jresize
from pfnl_tpu.ops import shuffle as jshuffle
from pfnl_tpu.ops.pallas.pfnl_tail import _fold_d2s_conv, compose_d2s4 as j_compose_d2s4

from pfnl_tpu_torch.ops import degrade, resize, shuffle
from pfnl_tpu_torch.ops.pfrb_ref import compose_d2s4, fold_d2s_conv

ATOL = 1e-6


@pytest.mark.parametrize("r,shape", [(2, (2, 3, 5, 84)), (4, (1, 2, 3, 48))])
def test_depth_to_space_tf_order(r, shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = shuffle.depth_to_space(torch.from_numpy(x), r).numpy()
    want = np.asarray(jshuffle.depth_to_space(jnp.asarray(x), r))
    np.testing.assert_allclose(got, want, atol=ATOL)
    back = shuffle.space_to_depth(torch.from_numpy(got), r).numpy()
    np.testing.assert_allclose(back, x, atol=0)


@pytest.mark.parametrize("shape", [(2, 6, 10, 21), (1, 12, 16, 3)])
def test_space_to_depth_tf_order(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = shuffle.space_to_depth(torch.from_numpy(x), 2).numpy()
    want = np.asarray(jshuffle.space_to_depth(jnp.asarray(x), 2))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n_in,n_out,method,mapping", [
    (12, 48, "bicubic", "tf1"), (7, 30, "bicubic", "half_pixel"),
    (9, 4, "bilinear", "tf1"), (5, 17, "bilinear", "align_corners"),
])
def test_resize_matrix_copy(n_in, n_out, method, mapping):
    got = resize._resize_matrix(n_in, n_out, method, mapping)
    want = jresize._resize_matrix(n_in, n_out, method, mapping)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape,size", [((2, 6, 10, 3), (24, 40)), ((1, 9, 13, 3), (36, 52))])
def test_resize_bicubic(shape, size):
    x = np.random.default_rng(2).random(shape).astype(np.float32)
    got = resize.resize_bicubic(torch.from_numpy(x), size).numpy()
    want = np.asarray(jresize.resize_bicubic(jnp.asarray(x), size))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_gaussian_kernel_copy():
    np.testing.assert_allclose(degrade.gaussian_kernel_2d(), jdegrade.gaussian_kernel_2d(),
                               atol=ATOL)
    np.testing.assert_allclose(degrade.gaussian_kernel_2d(9, 1.2),
                               jdegrade.gaussian_kernel_2d(9, 1.2), atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 48, 40, 3), (1, 37, 29, 3)])
def test_downsample_4d(shape):
    x = np.random.default_rng(3).random(shape).astype(np.float32)
    got = degrade.downsample_4d(torch.from_numpy(x)).numpy()
    want = np.asarray(jdegrade.downsample_4d(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fold_d2s_conv_copy():
    km2 = np.random.default_rng(4).standard_normal((3, 3, 12, 12)).astype(np.float32)
    got = fold_d2s_conv(torch.from_numpy(km2)).numpy()
    np.testing.assert_allclose(got, _fold_d2s_conv(km2), atol=ATOL)


def test_compose_d2s4():
    x = np.random.default_rng(5).standard_normal((2, 3, 5, 48)).astype(np.float32)
    got = compose_d2s4(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_compose_d2s4(jnp.asarray(x))), atol=ATOL)


def test_scan_dataset_dir_copy(tmp_path):
    from pfnl_tpu.data.manifest import scan_dataset_dir as j_scan
    from pfnl_tpu_torch.data.manifest import scan_dataset_dir

    for d in ("b_seq", "a_seq", "c_seq"):
        os.makedirs(tmp_path / d)
    (tmp_path / "notes.txt").write_text("not a sequence")
    assert scan_dataset_dir(str(tmp_path)) == j_scan(str(tmp_path))
    assert [os.path.basename(p) for p in scan_dataset_dir(str(tmp_path))] == [
        "a_seq", "b_seq", "c_seq"]
