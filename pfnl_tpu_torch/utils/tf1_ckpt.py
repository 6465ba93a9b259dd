"""TF-free reader for TensorFlow-1 checkpoints (TensorBundle V2 format)
plus the PFNL name-mapping importer — a copy of pfnl_tpu/utils/tf1_ckpt.py
(numpy only), so that the port loads nothing of the JAX package.

The reference distributes pre-trained TF1 checkpoints (loader
reference model/base_model.py:231-243).  This module reads the
`<prefix>.index` / `<prefix>.data-NNNNN-of-NNNNN` pair with NO
TensorFlow dependency, so the authors' weights can be imported anywhere
the port runs.

Format notes (tensorflow/core/util/tensor_bundle, a LevelDB-style table):

  * `.index` is an SSTable: prefix-compressed key/value blocks, an index
    block of BlockHandles, and a 48-byte footer ending in the magic
    0xdb4775248b80fb57.  TF writes it uncompressed (kNoCompression).
  * values are serialized BundleEntryProto messages: dtype(1), shape(2:
    TensorShapeProto{dim(2){size(1)}}), shard_id(3), offset(4), size(5),
    crc32c(6).  The empty key "" holds the BundleHeaderProto
    (num_shards(1)).
  * tensor bytes live in the shard files at [offset, offset+size),
    little-endian, C order.
"""

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

_TABLE_MAGIC = 0xDB4775248B80FB57

_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 9: np.int64, 10: np.bool_, 14: None,  # 14 = bfloat16
    17: np.uint16, 19: np.float16, 22: np.uint32, 23: np.uint64,
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_block_entries(data: bytes) -> List[Tuple[bytes, bytes]]:
    """Decode the prefix-compressed entries of one table block."""
    if len(data) < 4:
        return []
    (num_restarts,) = struct.unpack_from("<I", data, len(data) - 4)
    end = len(data) - 4 * (num_restarts + 1)
    entries = []
    pos = 0
    key = b""
    while pos < end:
        shared, pos = _read_varint(data, pos)
        non_shared, pos = _read_varint(data, pos)
        value_len, pos = _read_varint(data, pos)
        key = key[:shared] + data[pos:pos + non_shared]
        pos += non_shared
        value = data[pos:pos + value_len]
        pos += value_len
        entries.append((key, value))
    return entries


def _read_block(f, offset: int, size: int) -> bytes:
    f.seek(offset)
    data = f.read(size + 5)
    comp = data[size]
    if comp != 0:
        raise NotImplementedError(
            f"compressed bundle index block (type {comp}) not supported")
    return data[:size]


def _read_table(path: str) -> Dict[bytes, bytes]:
    """All key->value pairs of a LevelDB-format table file."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        flen = f.tell()
        f.seek(flen - 48)
        footer = f.read(48)
        (magic,) = struct.unpack_from("<Q", footer, 40)
        if magic != _TABLE_MAGIC:
            raise ValueError(f"{path}: not a TensorBundle index (bad magic)")
        pos = 0
        _, pos = _read_varint(footer, pos)       # metaindex offset
        _, pos = _read_varint(footer, pos)       # metaindex size
        idx_off, pos = _read_varint(footer, pos)
        idx_size, pos = _read_varint(footer, pos)
        index = _parse_block_entries(_read_block(f, idx_off, idx_size))
        out: Dict[bytes, bytes] = {}
        for _, handle in index:
            hpos = 0
            boff, hpos = _read_varint(handle, hpos)
            bsize, hpos = _read_varint(handle, hpos)
            for k, v in _parse_block_entries(_read_block(f, boff, bsize)):
                out[k] = v
    return out


def _parse_proto_fields(buf: bytes):
    """Yield (field_number, wire_type, value) for a protobuf message."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_shape(buf: bytes) -> List[int]:
    dims = []
    for field, _, val in _parse_proto_fields(buf):
        if field == 2:  # TensorShapeProto.Dim
            size = 0
            for f2, _, v2 in _parse_proto_fields(val):
                if f2 == 1:
                    size = v2
            dims.append(size)
    return dims


def _parse_entry(buf: bytes):
    dtype, shape, shard, offset, size = 1, [], 0, 0, 0
    for field, _, val in _parse_proto_fields(buf):
        if field == 1:
            dtype = val
        elif field == 2:
            shape = _parse_shape(val)
        elif field == 3:
            shard = val
        elif field == 4:
            offset = val
        elif field == 5:
            size = val
    return dtype, shape, shard, offset, size


def _parse_header(buf: bytes) -> int:
    num_shards = 1
    for field, _, val in _parse_proto_fields(buf):
        if field == 1:
            num_shards = val
    return num_shards


def list_tf1_variables(prefix: str) -> Dict[str, Tuple[List[int], int]]:
    """{name: (shape, dtype_enum)} without reading tensor data."""
    table = _read_table(prefix + ".index")
    out = {}
    for k, v in table.items():
        if not k:
            continue
        name = k.decode("utf-8")
        dtype, shape, _, _, _ = _parse_entry(v)
        out[name] = (shape, dtype)
    return out


def load_tf1_checkpoint(prefix: str) -> Dict[str, np.ndarray]:
    """Read every tensor of a TF1 checkpoint into numpy arrays."""
    table = _read_table(prefix + ".index")
    num_shards = _parse_header(table.get(b"", b""))
    shards = {}

    def shard_file(i):
        if i not in shards:
            shards[i] = open(
                prefix + f".data-{i:05d}-of-{num_shards:05d}", "rb")
        return shards[i]

    out = {}
    try:
        for k, v in table.items():
            if not k:
                continue
            name = k.decode("utf-8")
            dtype_enum, shape, shard, offset, size = _parse_entry(v)
            np_dtype = _DTYPES.get(dtype_enum)
            if dtype_enum == 14:  # bfloat16: read u16, upcast via f32 bits
                f = shard_file(shard)
                f.seek(offset)
                raw = np.frombuffer(f.read(size), np.uint16)
                arr = (raw.astype(np.uint32) << 16).view(np.float32)
            elif np_dtype is None:
                continue  # unsupported dtype (strings etc.)
            else:
                f = shard_file(shard)
                f.seek(offset)
                arr = np.frombuffer(f.read(size), np_dtype)
            out[name] = arr.reshape(shape)
    finally:
        for f in shards.values():
            f.close()
    return out


# --------------------------------------------------------------- PFNL import

def import_pfnl_tf1(prefix_or_dict, num_blocks: int = 20, num_frames: int = 7,
                    mf: int = 64) -> Dict:
    """Map the reference PFNL's TF1 variables (scope 'nlvsr', explicit
    layer names — reference model/pfnl.py:47-53, utils.py:23-67) to the
    flax param tree, which `utils.weights.from_flax` turns into the port's
    state_dict.

    Transforms: conv10_{i} [1,1,T*mf,mf] concat kernel -> [T,mf,mf]
    per-frame fusion weights; conv2_{i} [3,3,2*mf,mf] concat kernel ->
    (base, frame) halves conv2b/conv2f.  Optimizer slots (.../Adam*) and
    global_step are ignored."""
    if isinstance(prefix_or_dict, dict):
        tf_vars = prefix_or_dict
    else:
        tf_vars = load_tf1_checkpoint(prefix_or_dict)

    def get(name):
        key = f"nlvsr/{name}"
        if key not in tf_vars:
            raise KeyError(f"checkpoint is missing {key}")
        return np.asarray(tf_vars[key], np.float32)

    params: Dict = {}
    params["nlblock_0"] = {
        "g": {"kernel": get("nlblock_0/g/g/kernel"),
              "bias": get("nlblock_0/g/g/bias")},
        "w": {"kernel": get("nlblock_0/w/w/kernel"),
              "bias": get("nlblock_0/w/w/bias")},
    }
    params["conv0"] = {"kernel": get("conv0/kernel"), "bias": get("conv0/bias")}
    for i in range(num_blocks):
        params[f"conv1_{i}_kernel"] = get(f"conv1_{i}/kernel")
        params[f"conv1_{i}_bias"] = get(f"conv1_{i}/bias")
        wf = get(f"conv10_{i}/kernel")           # [1,1,T*mf,mf]
        params[f"conv10_{i}_kernel"] = np.stack(
            [wf[0, 0, mf * j:mf * (j + 1), :] for j in range(num_frames)])
        params[f"conv10_{i}_bias"] = get(f"conv10_{i}/bias")
        w2 = get(f"conv2_{i}/kernel")            # [3,3,2*mf,mf]
        params[f"conv2b_{i}_kernel"] = w2[:, :, :mf, :]
        params[f"conv2f_{i}_kernel"] = w2[:, :, mf:, :]
        params[f"conv2f_{i}_bias"] = get(f"conv2_{i}/bias")
    params["convmerge1_kernel"] = get("convmerge1/kernel")
    params["convmerge1_bias"] = get("convmerge1/bias")
    params["convmerge2_kernel"] = get("convmerge2/kernel")
    params["convmerge2_bias"] = get("convmerge2/bias")
    return params
