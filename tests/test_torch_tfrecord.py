"""The PyTorch port's TFRecord IO vs the JAX package's, on the CPU.

The port keeps its own copies of the pure-Python reader and encoders
(``data/tfrecord.py``), of the native C++ reader (``csrc/kccot_io.cc``,
built by the host compiler, bound in ``data/native_io.py``) and of the
backend dispatch (``data/io.py``).  On records written by the JAX
package's encoders, each port backend gives exactly what JAX's
pure-Python reader gives: the masked CRC32C, the framing, and the
parses of ``Example`` / ``SequenceExample`` with bytes, floats and
ints, negative ints, packed and unpacked lists.  The native cases skip
only where no C++ compiler is on PATH.  No JAX function is compiled.
"""

import struct

import numpy as np
import pytest

from kccotgan_tpu.data import tfrecord as jax_io
from kccotgan_tpu_torch import _build
from kccotgan_tpu_torch.data import io, native_io
from kccotgan_tpu_torch.data import tfrecord as py_io


def need_compiler():
    """Skip the calling test where no C++ compiler is on PATH to build the
    native reader (decided when the test runs, never at import)."""
    if not native_io.available():
        pytest.skip("no C++ compiler on PATH")


@pytest.fixture(params=["python", "native"])
def impl(request):
    """One of the port's two backends, as a module."""
    if request.param == "native":
        need_compiler()
        return native_io
    return py_io


def example_records(seed, n=4):
    rng = np.random.default_rng(seed)
    return [
        jax_io.encode_example({
            "x": rng.normal(size=(16,)).astype(np.float32).tolist(),
            "label": [int(rng.integers(0, 1000)), -3, 2**40, -(2**63), 2**63 - 1],
            "name": [f"sample-{i}".encode(), b"\x00\xff raw", b""],
        })
        for i in range(n)
    ]


def sequence_record(seed):
    rng = np.random.default_rng(seed)
    ctx = {
        "0/image_aux1/encoded": [bytes(rng.integers(0, 256, 64, dtype=np.uint8))],
        "meta": [3, -1, 4],
        "scale": [0.5, -2.25],
    }
    fl = {
        "frames": [[b"jpegdata1"], [b"jpegdata22", b"x"], [b"jpegdata333"]],
        "actions": [rng.normal(size=4).astype(np.float32).tolist() for _ in range(3)],
        "steps": [[1, -2], [2**35], [-7]],
    }
    return jax_io.encode_sequence_example(ctx, fl)


def varint(x):
    x &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def unpacked_record():
    """An Example with UNPACKED repeated fields (older writers): floats as
    wire-type 5, ints as one varint each (a negative one ten bytes)."""
    floats = b"".join(varint(1 << 3 | 5) + struct.pack("<f", v) for v in (1.5, -2.25))
    float_feat = varint(2 << 3 | 2) + varint(len(floats)) + floats
    ints = b"".join(varint(1 << 3 | 0) + varint(v) for v in (7, 300, -5))
    int_feat = varint(3 << 3 | 2) + varint(len(ints)) + ints

    def map_entry(key, feat):
        e = varint(1 << 3 | 2) + varint(len(key)) + key + varint(2 << 3 | 2) + varint(len(feat)) + feat
        return varint(1 << 3 | 2) + varint(len(e)) + e

    features = map_entry(b"f", float_feat) + map_entry(b"i", int_feat)
    return varint(1 << 3 | 2) + varint(len(features)) + features


def assert_parsed_equal(got, want):
    """Equal values of equal types: lists of bytes, of Python floats or
    ints, or numpy arrays of the same dtype."""
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            assert_parsed_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_parsed_equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 64, 1000])
def test_masked_crc32c_equal_jax(impl, n):
    data = bytes(np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8))
    assert impl.masked_crc32c(data) == jax_io.masked_crc32c(data)


def test_encoders_and_writer_equal_jax(tmp_path):
    """The port's encoders and writer produce JAX's bytes."""
    rng = np.random.default_rng(0)
    feats = {"x": rng.normal(size=5).astype(np.float32).tolist(), "i": [-1, 2**40], "b": [b"\x00a"]}
    assert py_io.encode_example(feats) == jax_io.encode_example(feats)
    ctx, fl = {"c": [1.0]}, {"frames": [[b"a"], [b"bc"]], "ints": [[-3], [4, 5]]}
    assert py_io.encode_sequence_example(ctx, fl) == jax_io.encode_sequence_example(ctx, fl)
    recs = example_records(1)
    py_io.write_tfrecord(str(tmp_path / "port.tfrecord"), recs)
    jax_io.write_tfrecord(str(tmp_path / "jax.tfrecord"), recs)
    assert (tmp_path / "port.tfrecord").read_bytes() == (tmp_path / "jax.tfrecord").read_bytes()


@pytest.mark.parametrize("verify_crc", [True, False])
def test_framing_round_trip(impl, verify_crc, tmp_path):
    recs = example_records(2) + [b""]
    path = str(tmp_path / "t.tfrecord")
    jax_io.write_tfrecord(path, recs)
    got = list(impl.iter_tfrecord(path, verify_crc=verify_crc))
    assert got == recs == list(jax_io.iter_tfrecord(path, verify_crc=verify_crc))


@pytest.mark.parametrize("offset", [9, 14], ids=["length_crc", "payload"])
def test_corrupt_crc_raises_under_verify_crc(impl, offset, tmp_path):
    recs = example_records(3, n=2)
    path = tmp_path / "bad.tfrecord"
    jax_io.write_tfrecord(str(path), recs)
    raw = bytearray(path.read_bytes())
    raw[offset] ^= 0xFF  # a byte of record 0's length crc, or of its payload
    path.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corrupt"):
        list(jax_io.iter_tfrecord(str(path), verify_crc=True))
    with pytest.raises(IOError, match="corrupt"):
        list(impl.iter_tfrecord(str(path), verify_crc=True))
    # without the check the (corrupt) payloads still come back as written
    got = list(impl.iter_tfrecord(str(path)))
    assert got == list(jax_io.iter_tfrecord(str(path)))
    assert len(got) == 2


@pytest.mark.parametrize("verify_crc", [True, False])
def test_truncated_record_raises(impl, verify_crc, tmp_path):
    recs = example_records(4, n=2)
    path = tmp_path / "cut.tfrecord"
    jax_io.write_tfrecord(str(path), recs)
    raw = path.read_bytes()
    path.write_bytes(raw[: len(raw) - 4 - len(recs[1]) // 2])  # half of record 1's payload
    for reader in (jax_io, impl):
        with pytest.raises(IOError, match="truncated record"):
            list(reader.iter_tfrecord(str(path), verify_crc=verify_crc))


def test_parse_example_equal_jax(impl):
    for rec in example_records(5) + [unpacked_record()]:
        assert_parsed_equal(impl.parse_example(rec), jax_io.parse_example(rec))


def test_parse_example_arrays_equal_jax(impl):
    for rec in example_records(6) + [unpacked_record()]:
        got = impl.parse_example_arrays(rec)
        assert_parsed_equal(got, jax_io.parse_example_arrays(rec))
        assert got["x" if "x" in got else "f"].dtype == np.float32


def test_parse_sequence_example_equal_jax(impl):
    rec = sequence_record(7)
    got = impl.parse_sequence_example(rec)
    want = jax_io.parse_sequence_example(rec)
    assert_parsed_equal(got, want)
    assert want[0]["meta"] == [3, -1, 4] and want[1]["steps"] == [[1, -2], [2**35], [-7]]


def test_native_is_byte_identical_to_python(tmp_path):
    """The port's two backends on one file of mixed records: the same
    payloads, and the same parse of each, under every parser."""
    need_compiler()
    recs = example_records(8) + [sequence_record(9), unpacked_record()]
    path = str(tmp_path / "mixed.tfrecord")
    py_io.write_tfrecord(path, recs)
    got = list(native_io.iter_tfrecord(path, verify_crc=True))
    assert got == list(py_io.iter_tfrecord(path, verify_crc=True)) == recs
    for rec in got:
        for parse in ("parse_example", "parse_example_arrays", "parse_sequence_example"):
            assert_parsed_equal(getattr(native_io, parse)(rec), getattr(py_io, parse)(rec))


def test_force_py_io_picks_python(monkeypatch):
    monkeypatch.setenv("KCCOT_FORCE_PY_IO", "1")
    assert io.backend() == "python"
    monkeypatch.delenv("KCCOT_FORCE_PY_IO")
    assert io.backend() == ("native" if native_io.available() else "python")


@pytest.fixture
def fresh_compiler(monkeypatch):
    """``_build.cxx`` looked up anew under this test's ``$CXX``, and again
    after it."""
    _build.cxx.cache_clear()
    yield monkeypatch
    monkeypatch.undo()
    _build.cxx.cache_clear()


def test_failed_build_raises_with_the_compilers_output(fresh_compiler):
    """A compiler that fails raises, naming it: never a quiet switch to
    the Python backend."""
    fresh_compiler.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        _build.load_io_library.__wrapped__()


def test_dispatch_raises_when_the_native_library_fails(monkeypatch):
    def broken():
        raise RuntimeError("g++ failed (1): boom")

    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "load_io_library", broken)
    monkeypatch.setattr(native_io, "available", lambda: True)
    monkeypatch.delenv("KCCOT_FORCE_PY_IO", raising=False)
    with pytest.raises(RuntimeError, match="boom"):
        io.parse_example(example_records(10, n=1)[0])


def test_no_compiler_picks_python(fresh_compiler):
    fresh_compiler.setenv("CXX", "no-such-compiler-kccot")
    fresh_compiler.delenv("KCCOT_FORCE_PY_IO", raising=False)
    assert io.backend() == "python"
