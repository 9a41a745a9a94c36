"""The port's checkpoint reader (``predict/ckpt.py``) against flax's
``serialization.msgpack_restore`` on every tracked checkpoint: the same
keys, shapes and dtypes, bit-equal arrays, the same ``epoch`` and
``step``.  Its msgpack decoder against the ``msgpack`` package on the
formats a checkpoint may hold."""
import glob

import msgpack
import numpy as np
import pytest
from flax import serialization

from catgrasp_tpu_torch.predict import ckpt

CKPTS = sorted(glob.glob("artifacts_tracked/*/*/best_val.ckpt"))


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_all_nine_checkpoints_are_tracked():
    assert len(CKPTS) == 9
    assert {p.split("/")[-2] for p in CKPTS} == {"seg", "nunocs", "grasp"}


@pytest.mark.parametrize("path", CKPTS, ids=lambda p: "-".join(p.split("/")[1:3]))
def test_reader_matches_flax(path):
    with open(path, "rb") as f:
        blob_j = serialization.msgpack_restore(f.read())
    blob_p = ckpt.read_checkpoint_blob(path)
    assert sorted(blob_p) == sorted(blob_j) == ["epoch", "params", "step"]
    assert (blob_p["epoch"], blob_p["step"]) == (blob_j["epoch"], blob_j["step"])
    assert blob_p["params"] == blob_j["params"]
    params_j = _flat(serialization.msgpack_restore(blob_j["params"]))
    params_p = _flat(ckpt.read_params(path))
    assert sorted(params_p) == sorted(params_j)
    for k, a in params_j.items():
        b = params_p[k]
        assert (b.shape, b.dtype) == (a.shape, a.dtype), k
        assert b.tobytes() == a.tobytes(), k


def test_decoder_matches_msgpack():
    """Every type the decoder takes, packed by the msgpack package: fixed
    and 8/16/32/64-bit ints of both signs, f32 and f64, nil and booleans,
    str and bin of each length prefix, fixarrays and array16, fixmaps and
    map16, and flax's ndarray and numpy-scalar ext types (fixext and
    ext8/16/32 payloads)."""
    arrs = [np.arange(n, dtype=np.float32).reshape(-1, 1) for n in (1, 3, 40, 20000)]
    ext = [msgpack.ExtType(1, msgpack.packb((a.shape, a.dtype.name, a.tobytes()),
                                            use_bin_type=True)) for a in arrs]
    scalar = msgpack.ExtType(3, msgpack.packb(((), "int64", np.int64(-7).tobytes()),
                                              use_bin_type=True))
    obj = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63, -1, -32, -33, -128,
                    -129, -32768, -32769, -2 ** 31 - 1],
           "floats": [1.5, -2.25e300], "none": None, "flags": [True, False],
           "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000],
           "bins": [b"", b"x" * 300, b"y" * 70000], "long": list(range(20)),
           "map16": {f"k{i}": i for i in range(20)}, "arrays": ext, "scalar": scalar}
    data = msgpack.packb(obj, use_bin_type=True) + msgpack.packb(0.5)
    out = ckpt.unpackb(msgpack.packb(obj, use_bin_type=True))
    ref = msgpack.unpackb(msgpack.packb(obj, use_bin_type=True), raw=False, strict_map_key=False)
    for k in ("ints", "floats", "none", "flags", "strs", "bins", "long", "map16"):
        assert out[k] == ref[k], k
    for a, b in zip(out["arrays"], arrs):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert out["scalar"] == -7 and isinstance(out["scalar"], np.int64)
    assert ckpt.unpackb(msgpack.packb(0.1, use_single_float=True)) == np.float32(0.1)
    with pytest.raises(ValueError, match="trailing"):
        ckpt.unpackb(data)
    with pytest.raises(ValueError, match="truncated"):
        ckpt.unpackb(msgpack.packb(obj, use_bin_type=True)[:-3])
    with pytest.raises(ValueError, match="ext type 5"):
        ckpt.unpackb(msgpack.packb(msgpack.ExtType(5, b"abcd")))


@pytest.mark.parametrize("path", CKPTS, ids=lambda p: "-".join(p.split("/")[1:3]))
def test_writer_reencodes_flax_bytes(path):
    """The port's encoder writes the tracked checkpoints' bytes back from
    what its reader reads: the outer map and the params blob."""
    with open(path, "rb") as f:
        raw = f.read()
    blob = ckpt.unpackb(raw)
    assert ckpt.packb(ckpt.unpackb(blob["params"])) == blob["params"]
    assert ckpt.packb(blob) == raw


def test_writer_round_trips_through_reader_and_flax(tmp_path):
    """Every type the encoder writes, read back by the port's reader, by
    ``flax.serialization.msgpack_restore`` and by the msgpack package; the
    integers in msgpack's own smallest forms."""
    arrs = [np.arange(n, dtype=np.float32).reshape(-1, 1) for n in (1, 3, 40, 20000)]
    obj = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63, -1, -32, -33, -128,
                    -129, -32768, -32769, -2 ** 31 - 1],
           "floats": [1.5, -2.25e300], "none": None, "flags": [True, False],
           "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000],
           "bins": [b"", b"x" * 300, b"y" * 70000], "long": list(range(20)),
           "map16": {f"k{i}": i for i in range(20)},
           "arrays": {str(i): a for i, a in enumerate(arrs)},
           "dtypes": {d: np.ones((2, 3), d) for d in ("float16", "int32", "int64", "bool",
                                                      "uint8", "float64")},
           "count": np.asarray(7, np.int32), "scalar": np.int64(-7)}
    data = ckpt.packb(obj)
    for other in ("ints", "floats", "none", "flags", "strs", "bins", "long", "map16"):
        assert ckpt.packb(obj[other]) == msgpack.packb(obj[other], use_bin_type=True), other
    back = ckpt.unpackb(data)
    flax_back = serialization.msgpack_restore(data)
    for out in (back, flax_back):
        for k in ("ints", "floats", "none", "flags", "strs", "bins", "long", "map16"):
            assert out[k] == obj[k], k
        for k, a in obj["arrays"].items():
            assert out["arrays"][k].dtype == a.dtype and np.array_equal(out["arrays"][k], a)
        for k, a in obj["dtypes"].items():
            assert out["dtypes"][k].dtype == a.dtype and np.array_equal(out["dtypes"][k], a)
        assert out["count"].shape == () and out["count"].dtype == np.int32 and out["count"] == 7
        assert out["scalar"] == -7 and isinstance(out["scalar"], np.int64)
    with pytest.raises(TypeError):
        ckpt.packb({"x": object()})
