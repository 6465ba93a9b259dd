"""TF1-checkpoint name mappings for all seven model families — a copy of
pfnl_tpu/utils/tf1_imports.py (numpy only), so that the port loads nothing
of the JAX package.

The reference ships pre-trained TF1 checkpoints for every model
(reference checkpoint/README.md:1-3, loaded via model/base_model.py:231-243).
`tf1_ckpt.py` provides the TF-free TensorBundle reader and the PFNL
mapping; this module adds the other six families, so that
`python -m pfnl_tpu_torch import-tf1 <model>` covers the whole zoo.

Naming conventions observed in the reference graphs:

  * slim.conv2d / slim.conv2d_transpose create `<scope>/weights`,
    `<scope>/biases` (VESPCN/MCResNet/DRVSR srmodel scopes,
    model/vespcn.py:83-98, model/mcresnet.py:87-111, model/drvsr.py:154-184;
    EASYFLOW, modules/model_easyflow.py:72-98).  The prelu activation runs
    inside the layer's variable scope, so its slope lives at
    `<scope>/alpha` (modules/videosr_ops.py:44-51).
  * tf.layers.conv2d / conv2d_transpose create `<scope>/kernel`,
    `<scope>/bias` (LTDVSR, model/ltdvsr.py:94-125; FRVSR,
    model/frvsr.py:53-96).
  * the ConvLSTM gate conv is `srmodel/convLSTM/LSTM_conv/{weights,biases}`
    (modules/BasicConvLSTMCell.py:80-140).
  * DUF's Conv3D/BatchNorm use `G/<name>/{W,b}` and
    `G/<name>/{beta,gamma,moving_mean,moving_variance}`
    (utils.py:251-288, model/nets.py, model/dufvsr.py:45).  The
    `G/DynFilter3D/filter_localexpand` constant variable
    (utils.py:339-340) is an identity conv kernel, NOT a weight — skipped.

TF conv2d_transpose kernels are [kh,kw,out,in] and need a spatial mirror
plus channel transpose to become flax ConvTranspose [kh,kw,in,out]
(lax.conv_transpose does not flip the kernel) — the same conversion the
golden-model tests validate (tests/test_golden_models.py:610-616).

Every importer accepts either a checkpoint prefix or a pre-loaded
{name: array} dict and returns the flax `params` tree (DUF additionally
returns the `batch_stats` tree), nested dicts of numpy arrays that
`utils.weights.from_flax` turns into the port's state_dict.  Optimizer slots (`.../Adam*`,
`global_step`, beta powers) are never requested, hence ignored.
"""

from typing import Dict, Tuple

import numpy as np

from pfnl_tpu_torch.utils.tf1_ckpt import import_pfnl_tf1, load_tf1_checkpoint


def _getter(prefix_or_dict):
    if isinstance(prefix_or_dict, dict):
        tf_vars = prefix_or_dict
    else:
        tf_vars = load_tf1_checkpoint(prefix_or_dict)

    def get(name):
        if name not in tf_vars:
            raise KeyError(f"checkpoint is missing {name}")
        return np.asarray(tf_vars[name], np.float32)

    return get


def _conv_slim(get, scope):
    return {"kernel": get(f"{scope}/weights"), "bias": get(f"{scope}/biases")}


def _conv_layers(get, scope):
    return {"kernel": get(f"{scope}/kernel"), "bias": get(f"{scope}/bias")}


def _deconv(k_tf):
    """TF conv2d_transpose kernel [kh,kw,out,in] -> flax [kh,kw,in,out]."""
    return np.ascontiguousarray(k_tf[::-1, ::-1].transpose(0, 1, 3, 2))


def _deconv_slim(get, scope):
    return {"kernel": _deconv(get(f"{scope}/weights")),
            "bias": get(f"{scope}/biases")}


def _deconv_layers(get, scope):
    return {"kernel": _deconv(get(f"{scope}/kernel")),
            "bias": get(f"{scope}/bias")}


_EASYFLOW_LAYERS = ("c1", "c2", "c3", "c4", "c5", "s1", "s2", "s3", "s4", "s5")


def _easyflow(get, scope="easyflow"):
    """EASYFLOW subnet (modules/model_easyflow.py:72-98), slim naming."""
    return {l: _conv_slim(get, f"{scope}/{l}") for l in _EASYFLOW_LAYERS}


def import_vespcn_tf1(prefix_or_dict, num_frames: int = 3) -> Dict:
    """VESPCN (model/vespcn.py:51-106): EASYFLOW + srmodel
    enc1/enc2_{0..8}/conv6/rnn_out with prelu slopes per conv scope."""
    get = _getter(prefix_or_dict)
    params: Dict = {"easyflow": _easyflow(get)}
    params["enc1"] = _conv_slim(get, "srmodel/enc1")
    params["prelu_0"] = {"alpha": get("srmodel/enc1/alpha")}
    for i in range(9):
        params[f"enc2_{i}"] = _conv_slim(get, f"srmodel/enc2_{i}")
        params[f"prelu_{i + 1}"] = {"alpha": get(f"srmodel/enc2_{i}/alpha")}
    params["conv6"] = _conv_slim(get, "srmodel/conv6")
    params["prelu_10"] = {"alpha": get("srmodel/conv6/alpha")}
    params["rnn_out"] = _conv_slim(get, "srmodel/rnn_out")  # no activation
    return params


def import_mcresnet_tf1(prefix_or_dict, num_frames: int = 5) -> Dict:
    """MCResNet (model/mcresnet.py:87-111): distance-shared enc1_{d}
    encoders; the flax tree keeps per-FRAME prelu modules, so the shared
    TF slope alpha_d is fanned out to every frame at that distance."""
    get = _getter(prefix_or_dict)
    idx0 = num_frames // 2
    params: Dict = {"easyflow": _easyflow(get)}
    for d in range(idx0 + 1):
        params[f"enc1_{d}"] = _conv_slim(get, f"srmodel/enc1_{d}")
    for i in range(num_frames):
        params[f"enc1_prelu_{i}"] = {
            "alpha": get(f"srmodel/enc1_{abs(i - idx0)}/alpha")}
    for i in range(9):
        params[f"enc2_{i}"] = _conv_slim(get, f"srmodel/enc2_{i}")
        params[f"enc2_prelu_{i}"] = {"alpha": get(f"srmodel/enc2_{i}/alpha")}
    params["conv6"] = _conv_slim(get, "srmodel/conv6")
    params["conv6_prelu"] = {"alpha": get("srmodel/conv6/alpha")}
    params["rnn_out"] = _conv_slim(get, "srmodel/rnn_out")
    return params


def import_ltdvsr_tf1(prefix_or_dict, num_frames: int = 5) -> Dict:
    """LTDVSR (model/ltdvsr.py:88-149): tf.layers naming under scopes
    'flow' (pooled flow net) and 'ltdvsr' (3 branches + temporal net)."""
    get = _getter(prefix_or_dict)
    params: Dict = {
        "flow": {f"conv{j}": _conv_layers(get, f"flow/conv{j}")
                 for j in range(3)}
    }
    for b in range(3):
        for l in range(4):  # conv{b}_{0,1,3,2} all exist as plain names
            params[f"conv{b}_{l}"] = _conv_layers(get, f"ltdvsr/conv{b}_{l}")
    for j in range(3):
        params[f"tem{j}"] = _conv_layers(get, f"ltdvsr/tem{j}")
    return params


def import_drvsr_tf1(prefix_or_dict, num_frames: int = 3) -> Dict:
    """DRVSR (model/drvsr.py:154-184): EASYFLOW + srmodel encoder/
    ConvLSTM/decoder; dec1/dec2 are transpose convs."""
    get = _getter(prefix_or_dict)
    sm: Dict = {}
    for name in ("enc1", "enc2", "enc2_1", "enc3", "enc3_1",
                 "dec1_1", "dec2_1", "dec3"):
        sm[name] = _conv_slim(get, f"srmodel/{name}")
    sm["dec1"] = _deconv_slim(get, "srmodel/dec1")
    sm["dec2"] = _deconv_slim(get, "srmodel/dec2")
    sm["lstm"] = {"gates": _conv_slim(get, "srmodel/convLSTM/LSTM_conv")}
    return {"easyflow": _easyflow(get), "srmodel": sm}


def import_frvsr_tf1(prefix_or_dict, num_frames: int = 10,
                     num_blocks: int = 10) -> Dict:
    """FRVSR (model/frvsr.py:41-96): tf.layers naming under scopes 'flow'
    (3-level U-net) and 'frvsr' (residual trunk + transpose-conv head)."""
    get = _getter(prefix_or_dict)
    flow: Dict = {}
    for p in range(3):
        for q in range(2):
            flow[f"conv0_{p}_{q}"] = _conv_layers(get, f"flow/conv0_{p}_{q}")
            flow[f"conv1_{p}_{q}"] = _conv_layers(get, f"flow/conv1_{p}_{q}")
    flow["conv2"] = _conv_layers(get, "flow/conv2")
    flow["conv3"] = _conv_layers(get, "flow/conv3")
    params: Dict = {"flow": flow}
    params["conv0_0"] = _conv_layers(get, "frvsr/conv0_0")
    params["conv0_1"] = _conv_layers(get, "frvsr/conv0_1")
    for j in range(num_blocks):
        params[f"conv1_{j}"] = _conv_layers(get, f"frvsr/conv1_{j}")
        params[f"conv2_{j}"] = _conv_layers(get, f"frvsr/conv2_{j}")
    params["large1"] = _deconv_layers(get, "frvsr/large1")
    params["large2"] = _deconv_layers(get, "frvsr/large2")
    params["out"] = _conv_layers(get, "frvsr/out")
    return params


_DUF_BLOCKS = {16: (3, 3), 28: (9, 3), 52: (21, 3)}


def import_duf_tf1(prefix_or_dict, layers: int = 52) -> Tuple[Dict, Dict]:
    """DUF (model/dufvsr.py:45 + model/nets.py + utils.py:251-288):
    scope 'G'; returns (params, batch_stats).  Skips the
    DynFilter3D/filter_localexpand constant (utils.py:339-340)."""
    get = _getter(prefix_or_dict)
    n_thw, n_hw = _DUF_BLOCKS[layers]

    def c3d(name):
        return {"W": get(f"G/{name}/W"), "b": get(f"G/{name}/b")}

    def bn(name):
        # TF checkpoints store the zero_debias shadows as
        # <name>/moving_*/biased and /local_step sub-variables; restored
        # checkpoints are long past warm-up, so synthesize
        # biased == moving (debias factor ~= 1 at large t) rather than
        # requiring the shadows to be present in every export.
        mm = get(f"G/{name}/moving_mean")
        mv = get(f"G/{name}/moving_variance")
        return ({"beta": get(f"G/{name}/beta"), "gamma": get(f"G/{name}/gamma")},
                {"moving_mean": mm, "moving_variance": mv,
                 "biased_mean": mm.copy(), "biased_var": mv.copy(),
                 "local_step": np.asarray(1e7, np.float32)})

    g: Dict = {"conv1": c3d("conv1")}
    gb: Dict = {}
    for r in range(1, n_thw + n_hw + 1):
        for s in ("a", "b"):
            g[f"Rbn{r}{s}"], gb[f"Rbn{r}{s}"] = bn(f"Rbn{r}{s}")
            g[f"Rconv{r}{s}"] = c3d(f"Rconv{r}{s}")
    g["fbn1"], gb["fbn1"] = bn("fbn1")
    for name in ("conv2", "rconv1", "rconv2", "fconv1", "fconv2"):
        g[name] = c3d(name)
    return {"G": g}, {"G": gb}


def _parse_hdf5_name(name: str) -> str:
    """The reference's name mangling (utils.py:300-306): '_' between two
    other characters becomes '/', then '__' becomes '_'."""
    chars = list(name)
    for i in range(1, len(chars) - 1):
        if chars[i] == "_" and chars[i - 1] != "_" and chars[i + 1] != "_":
            chars[i] = "/"
    return "".join(chars).replace("__", "_")


def _flatten(tree, prefix=""):
    """[('/'-joined path, leaf)] of a nested dict, in its order."""
    out = []
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.extend(_flatten(v, path) if isinstance(v, dict) else [(path, v)])
    return out


def _set(tree, path, value):
    """A copy of the nested dict `tree` with the leaf at `path` replaced."""
    head, _, rest = path.partition("/")
    out = dict(tree)
    out[head] = _set(tree[head], rest, value) if rest else value
    return out


def load_hdf5_params(tree, h5_path: str, group: str = "params", verbose: bool = True):
    """A copy of the nested dict `tree` with the leaves replaced that an
    hdf5 dataset of `group` names (pfnl_tpu/utils/param_io.py
    `load_hdf5_params`, reference utils.py:290-318): the mangled dataset
    name equals the '/'-joined path (case-insensitive), or one is a suffix
    of the other; the shapes must agree.  h5py is imported here, on first
    use."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"reading the hdf5 weights {h5_path} needs h5py, which is not "
                          f"installed") from e
    leaves = _flatten(tree)
    with h5py.File(h5_path, "r") as f:
        g = f[group]
        loaded, misses = {}, []
        for name in g:
            parsed = _parse_hdf5_name(name).lower()
            hit = next((i for i, (p, _) in enumerate(leaves)
                        if p.lower() == parsed or p.lower().endswith("/" + parsed)
                        or parsed.endswith("/" + p.lower())), None)
            if hit is None:
                misses.append(name)
                continue
            arr = np.asarray(g[name])
            if arr.shape != np.shape(leaves[hit][1]):
                misses.append(f"{name} (shape {arr.shape} != {np.shape(leaves[hit][1])})")
                continue
            loaded[hit] = arr
    if verbose:
        for m in misses:
            print(f"Warning::Cant find param: {m}, ignore if intended.")
        print(f"Parameters are loaded ({len(loaded)}/{len(leaves)} leaves)")
    for i, arr in loaded.items():
        tree = _set(tree, leaves[i][0], arr)
    return tree


def import_duf_hdf5(params, batch_stats, h5_path: str, verbose=True):
    """Original VSR-DUF weights via the reference's hdf5 LoadParams path
    (utils.py:290-318), applied to both collections (nested dicts of
    arrays, flax's layout)."""
    params = load_hdf5_params(params, h5_path, verbose=verbose)
    batch_stats = load_hdf5_params(batch_stats, h5_path, verbose=verbose)

    # Imported checkpoints are long past BN warm-up: seed the zero_debias
    # shadows (biased accumulator == already-debiased moving stat, large
    # step) so continued training doesn't re-debias from zero.
    def _seed(tree):
        if not isinstance(tree, dict):
            return tree
        if "moving_mean" in tree:
            out = dict(tree)
            out["biased_mean"] = tree["moving_mean"]
            out["biased_var"] = tree["moving_variance"]
            out["local_step"] = np.asarray(1e7, np.float32)
            return out
        return {k: _seed(v) for k, v in tree.items()}

    return params, _seed(batch_stats)


# model -> (importer, kwargs-from-config, returns_batch_stats)
IMPORTERS = {
    "pfnl": (import_pfnl_tf1, ("num_frames",), False),
    "vespcn": (import_vespcn_tf1, ("num_frames",), False),
    "mcresnet": (import_mcresnet_tf1, ("num_frames",), False),
    "ltdvsr": (import_ltdvsr_tf1, ("num_frames",), False),
    "drvsr": (import_drvsr_tf1, ("num_frames",), False),
    "frvsr": (import_frvsr_tf1, ("num_frames",), False),
    "duf": (import_duf_tf1, (), True),
}
