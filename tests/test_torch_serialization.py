"""Torch tensors in the port's object serialization
(``ray_tpu_torch/_private/serialization.py``).

A tensor is copied to the host once at the put boundary and read back as
a CPU tensor of the same dtype and shape, bit for bit (bf16 has no numpy
dtype and travels as raw bytes with a dtype tag).  From
``INLINE_ARRAY_THRESHOLD`` bytes on it travels out of band, like a numpy
array.  Over writable store memory the tensor shares it; over read-only
memory it is a private copy, so an in-place write never reaches the
store.  Values without tensors pack to the JAX package's bytes."""
import mmap
import pickle
from multiprocessing import shared_memory

import numpy as np
import pytest
import torch

from ray_tpu._private import serialization as jser
from ray_tpu_torch._private import serialization as ser

DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int64,
          torch.bool)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tensor(dtype, shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype == torch.int64:
        return torch.randint(-2**40, 2**40, shape, generator=g)
    return (torch.randn(shape, generator=g) * 3).to(dtype)


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _round_trip(value, readonly=False):
    s = ser.serialize(value)
    meta, data = ser.pack(s)
    buf = memoryview(bytes(data) if readonly else bytearray(data))
    out, _ = ser.unpack(meta, buf)
    return out, s


def _same(a, b):
    return (type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape
            and a.device.type == "cpu" and torch.equal(_bits(a), _bits(b)))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_tensors_round_trip_bitwise(dtype, layout):
    t = _tensor(dtype, (64, 48))
    if layout == "strided":
        t = t.t()[::2]  # transposed and stepped: not contiguous
        assert not t.is_contiguous()
    out, _ = _round_trip(t)
    assert _same(out, t)
    nested = {"w": [t, (t[:3], 7)], "name": "x"}
    got, _ = _round_trip(nested)
    assert _same(got["w"][0], t) and _same(got["w"][1][0], t[:3])
    assert got["w"][1][1] == 7 and got["name"] == "x"


@pytest.mark.parametrize("shape", [(), (0, 3), (1,)], ids=str)
def test_scalar_and_empty_tensors(shape):
    for dtype in DTYPES:
        t = _tensor(dtype, shape)
        out, _ = _round_trip(t)
        assert _same(out, t)


def test_large_tensors_travel_out_of_band_small_ones_inline():
    big = _tensor(torch.bfloat16, (512, 512))      # 512 KiB
    small = _tensor(torch.float32, (8,))           # 32 B
    _, s_big = _round_trip({"a": big, "b": small})
    assert len(s_big.buffers) == 1
    assert memoryview(s_big.buffers[0]).nbytes == big.numel() * 2
    _, s_small = _round_trip(small)
    assert not s_small.buffers
    # A view sends its own elements, not its base's whole storage.
    _, s_view = _round_trip(big[:4])
    assert sum(memoryview(b).nbytes for b in s_view.buffers) + \
        len(s_view.inband) < 8 * 1024


def test_parameters_and_requires_grad_survive():
    p = torch.nn.Parameter(_tensor(torch.float32, (4, 4)))
    g = _tensor(torch.float32, (3,)).requires_grad_(True)
    out, _ = _round_trip({"p": p, "g": g, "n": g.detach()})
    assert isinstance(out["p"], torch.nn.Parameter) and out["p"].requires_grad
    assert out["g"].requires_grad and not out["n"].requires_grad
    assert torch.equal(out["p"].detach(), p.detach())


def test_in_place_writes_share_writable_memory_and_copy_read_only():
    t = _tensor(torch.float32, (1024,))  # out of band
    s = ser.serialize(t)
    size = ser.packed_size(s)
    seg = shared_memory.SharedMemory(create=True, size=size)
    try:
        meta = ser.pack_into(s, seg.buf)
        ro = mmap.mmap(-1, size)
        ro[:] = bytes(seg.buf[:size])
        # Writable store memory (a segment): a zero-copy view, exactly
        # where a numpy array read back from it would be writable.  (The
        # checks go to plain bools: pytest's rewritten asserts would keep
        # the views alive past the segment's close.)
        shared, _ = ser.unpack(meta, seg.buf)
        shared.add_(1.0)
        again, _ = ser.unpack(meta, seg.buf)
        write_landed = torch.equal(again, t + 1.0)
        del shared, again, _
        assert write_landed
        js = jser.serialize(t.numpy())
        jmeta = jser.pack_into(js, seg.buf)
        arr, _ = jser.unpack(jmeta, seg.buf)
        numpy_writable = bool(arr.flags.writeable)
        del arr, _
        assert numpy_writable
        # Read-only memory (the arena and spill files are mapped read-only):
        # a private copy, so the write never reaches the stored bytes.
        view = memoryview(ro).toreadonly()
        private, _ = ser.unpack(meta, view)
        private.add_(1.0)
        again, _ = ser.unpack(meta, view)
        assert torch.equal(again, t) and torch.equal(private, t + 1.0)
    finally:
        seg.close()
        seg.unlink()


def test_inline_bytes_are_copied_not_aliased():
    t = _tensor(torch.float32, (4,))
    out, _ = _round_trip(t, readonly=True)
    out.add_(1.0)
    out2, _ = _round_trip(t, readonly=True)
    assert torch.equal(out2, t)


@pytest.mark.parametrize("value", [
    42, "text", {"a": [1, 2.5, None]},
    np.arange(5000, dtype=np.float32).reshape(50, 100),
    {"x": np.ones(10, np.int64), "y": (np.zeros(4000, np.float64),)},
], ids=["int", "str", "dict", "array", "nested_arrays"])
def test_values_without_tensors_pack_to_the_reference_bytes(value):
    meta, data = ser.pack(ser.serialize(value))
    jmeta, jdata = jser.pack(jser.serialize(value))
    assert pickle.loads(meta) == pickle.loads(jmeta)
    assert data == jdata


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_cuda_tensors_come_back_on_the_cpu(dtype):
    t = _tensor(dtype, (256, 64)).cuda()
    out, s = _round_trip({"t": t, "view": t[1:3]})
    assert out["t"].device.type == "cpu"
    assert _same(out["t"], t.cpu()) and _same(out["view"], t[1:3].cpu())
    assert len(s.buffers) == 1
