"""External parameter import (counterpart: pfnl_tpu/utils/param_io.py, but
for `load_hdf5_params`, which lives in utils/tf1_imports.py).

  * get_num_params: the parameter count the trainers print (reference
    utils.py:87-92);
  * load_caffe_flownet: Caffe-layout FlowNet-S/C weights into the port's
    FlowNet parameters (models/flownet.py), which keep flax's names and
    layouts (a conv `kernel` HWIO, a transposed conv's [kh,kw,in,out]), so
    the Caffe blobs take the same permutations as in the JAX package.
"""

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def get_num_params(model: nn.Module) -> int:
    """Total parameter count (reference utils.py:87-92)."""
    return sum(p.numel() for p in model.parameters())


# Caffe FlowNet layer names -> the decoder names of models/flownet.py.  The
# reference's TF variable scopes mirror the caffemodel layer names
# (weight_from_caffe, modules/utils.py:4-10, looks blobs up by the last
# scope segment), so these are the caffemodel names.
_FLOWNET_DECODER_MAP = {
    "Convolution1": "predict_flow6",
    "Convolution2": "predict_flow5",
    "Convolution3": "predict_flow4",
    "Convolution4": "predict_flow3",
    "Convolution5": "predict_flow2",
    "upsample_flow6to5": "upsample_flow6",
    "upsample_flow5to4": "upsample_flow5",
    "upsample_flow4to3": "upsample_flow4",
    "upsample_flow3to2": "upsample_flow3",
    "deconv5": "deconv5",
    "deconv4": "deconv4",
    "deconv3": "deconv3",
    "deconv2": "deconv2",
}


def _caffe_conv_kernel(w: np.ndarray) -> np.ndarray:
    """Caffe conv blob [out, in, kh, kw] -> HWIO, the permutation the
    reference applies at modules/utils.py:9 ([2,3,1,0])."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _caffe_deconv_kernel(w: np.ndarray) -> np.ndarray:
    """Caffe deconv blob [in, out, kh, kw] -> flax ConvTranspose [kh, kw,
    in, out]: the reference's [2,3,1,0] gives TF's conv2d_transpose layout
    [kh, kw, out, in]; flax's transposed conv does not flip its kernel, so
    the kernel is mirrored spatially and its channel axes swapped (the rule
    of tf1_imports' deconvolutions)."""
    k_tf = np.transpose(w, (2, 3, 1, 0))
    return np.ascontiguousarray(k_tf[::-1, ::-1].transpose(0, 1, 3, 2))


def load_caffe_flownet(params: Mapping[str, torch.Tensor], caffe_params,
                       verbose: bool = True) -> Dict[str, torch.Tensor]:
    """Caffe-layout FlowNet-S/C weights into a copy of `params` (a FlowNet's
    state_dict, '.'-joined flax names); load the result with
    `load_state_dict`.  (Replaces the pycaffe loaders at
    modules/utils.py:4-17.)

    `caffe_params`: caffemodel layer name -> (weight, bias) numpy arrays in
    Caffe blob layout (conv [out,in,kh,kw], deconv [in,out,kh,kw]).  A blob
    whose layer has no parameter of that name, or whose shape differs from
    it, is left out with a warning naming the layer, like the reference's
    LoadParams (utils.py:314-316)."""
    paths = list(params)
    out = dict(params)
    loaded, misses = set(), []
    for name, (w, b) in caffe_params.items():
        is_deconv = name.startswith(("deconv", "upsample_flow"))
        target = _FLOWNET_DECODER_MAP.get(name, name)
        kernel = (_caffe_deconv_kernel if is_deconv else _caffe_conv_kernel)(np.asarray(w))
        for leaf_name, arr in (("kernel", kernel), ("bias", np.asarray(b))):
            want = f"{target}.{leaf_name}"
            hit = next((p for p in paths if p == want or p.endswith("." + want)), None)
            if hit is None:
                misses.append(f"{name} ({leaf_name})")
            elif tuple(arr.shape) != tuple(params[hit].shape):
                misses.append(f"{name} ({leaf_name} shape {tuple(arr.shape)} != "
                              f"{tuple(params[hit].shape)})")
            else:
                out[hit] = torch.from_numpy(np.array(arr, np.float32))
                loaded.add(hit)
    if verbose:
        for m in misses:
            print(f"Warning::Cant find param: {m}, ignore if intended.")
        print(f"Caffe params loaded ({len(loaded)}/{len(paths)} leaves)")
    return out
