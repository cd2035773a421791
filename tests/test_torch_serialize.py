"""The port's own msgpack codec (lp_gnn_tpu_torch/utils/serialize.py)
against the ``msgpack`` package with the JAX package's ndarray encoder
(lp_gnn_tpu/utils/serialize.py:32-86): byte-identical output on blob-shaped
objects, and blobs written by either side read back by the other."""
import msgpack
import numpy as np
import pytest
import torch

from lp_gnn_tpu.utils import serialize as jser
from lp_gnn_tpu_torch.utils import serialize as tser

torch.set_num_threads(2)


def blob_objects():
    rng = np.random.RandomState(0)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    return {
        # a processed blob: [row, col, data, c_feas, v_feas, y_s, y_t, nnodes]
        "processed": [rng.randint(0, 9, 40).astype(np.int32),
                      rng.randint(0, 9, 40).astype(np.int32),
                      rng.randn(40), rng.rand(9, 8).astype(np.float32),
                      rng.rand(9, 8).astype(np.float32),
                      rng.randint(0, 3, 9).astype(np.int64),
                      rng.randint(0, 3, 9).astype(np.int64), 18],
        # its .meta sidecar
        "meta": dict(num_cons=3, num_vars=70000, raw_path="raw/lp_1.pk",
                     processed_path="processed/lp_1.pk",
                     con_nms=["c0", "R" * 40, "é" * 200],
                     var_nms=[f"x{j}" for j in range(70000)]),
        "scalars": [None, True, False, 0.5, -1e300, float("inf"),
                    np.float64(2.5), np.int64(-7), np.float32(1.5),
                    np.bool_(True), np.array(3.0), *ints],
        "containers": [{}, [], (1, 2), {f"k{i}": i for i in range(20)},
                       list(range(16)), {b"raw": b"\x00" * 300},
                       {"s": "x" * 70000, "b": b"y" * 70000},
                       np.zeros((0, 3), np.float32),
                       np.arange(12, dtype=np.uint16).reshape(3, 4)[:, ::2],
                       [np.array([True, False])]],
    }


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert type(a) is type(b) and (a == b or a != a), (a, b)


@pytest.mark.parametrize("name", list(blob_objects()))
def test_packb_byte_identical_to_msgpack(name):
    obj = blob_objects()[name]
    want = msgpack.packb(obj, default=jser._encode_np, use_bin_type=True)
    assert tser.packb(obj) == want
    # and what msgpack wrote reads back as msgpack reads it
    ref = msgpack.unpackb(want, object_hook=jser._decode_np, raw=False,
                          strict_map_key=False)
    _same(tser.unpackb(want), ref)


def test_blob_files_cross_read(tmp_path):
    obj = blob_objects()["processed"]
    jax_fn, port_fn = str(tmp_path / "jax.pk"), str(tmp_path / "port.pk")
    jser.msgpack_dump(obj, jax_fn)
    tser.msgpack_dump(obj, port_fn)
    with open(jax_fn, "rb") as a, open(port_fn, "rb") as b:
        assert a.read() == b.read()
    got = tser.msgpack_load(jax_fn)
    _same(got, jser.msgpack_load(port_fn))
    got[3][0, 0] = 9.0   # copy=True gives writable arrays
    view = tser.msgpack_load(jax_fn, copy=False)
    assert not view[3].flags.writeable


def test_codec_rejects_what_it_cannot_carry():
    with pytest.raises(TypeError):
        tser.packb(object())
    with pytest.raises(TypeError):
        tser.packb(np.array([object()]))
    with pytest.raises(OverflowError):
        tser.packb(2 ** 64)
    with pytest.raises(ValueError, match="truncated"):
        tser.unpackb(tser.packb("abcdef")[:-1])
    with pytest.raises(ValueError, match="extra bytes"):
        tser.unpackb(tser.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="unsupported"):
        tser.unpackb(b"\xd4\x01\x00")   # fixext 1: not a blob type
