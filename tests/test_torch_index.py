"""The port's retrieval core against the JAX reference on the CPU: one
store, searched by the reference ``FlatIndex`` / ``DeviceStore`` and by
the port's (fp32, fp16, int8 stores; "kernel" and "gemm" layouts), the
upload-once ``DeviceStore`` with delta appends, the flat-only
``auto_index``, the hash embedder, and the shared on-disk store format."""
import numpy as np
import pytest

from repro.core.embedder import HashEmbedder as JHashEmbedder
from repro.core.index import DeviceStore as JDeviceStore
from repro.core.index import FlatIndex as JFlatIndex
from repro.core.store import PrecomputedStore as JStore
from repro_torch.core.embedder import HashEmbedder
from repro_torch.core.index import (DeviceStore, FlatIndex, auto_index,
                                    cached_device_store, device_store_for,
                                    select_tier)
from repro_torch.core.store import PrecomputedStore


def _rows(n, d=48, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _write(cls, root, x, emb_dtype, shard_rows=256):
    st = cls(root, dim=x.shape[1], emb_dtype=emb_dtype,
             shard_rows=shard_rows)
    st.add_batch(x, [f"q{i}" for i in range(len(x))],
                 [f"r{i}" for i in range(len(x))])
    st.flush()
    return st


def _queries(x, n=40, seed=1):
    rng = np.random.default_rng(seed)
    q = x[rng.integers(0, len(x), n)] \
        + 0.05 * rng.normal(size=(n, x.shape[1])).astype(np.float32)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([q, _rows(8, x.shape[1], seed + 5)]).astype(
        np.float32)


@pytest.mark.parametrize("emb_dtype", ["float32", "float16", "int8"])
def test_store_written_by_port_is_byte_identical(tmp_path, emb_dtype):
    x = _rows(700)
    a = _write(JStore, tmp_path / "jax", x, emb_dtype)
    b = _write(PrecomputedStore, tmp_path / "port", x, emb_dtype)
    a.close()
    b.close()
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == \
            (tmp_path / "port" / n).read_bytes(), n


@pytest.mark.parametrize("emb_dtype", ["float32", "float16", "int8"])
@pytest.mark.parametrize("layout", ["gemm", "kernel"])
def test_flat_search_matches_reference(tmp_path, emb_dtype, layout):
    """Same store, same queries: identical ids at k=1, values within 1e-5
    (the int8 kernel layout quantizes the query too, in both packages)."""
    x = _rows(900, seed=2)
    st = _write(JStore, tmp_path / "s", x, emb_dtype)
    q = _queries(x)
    vj, ij = JDeviceStore(st, layout=layout).search(q, 1)
    port = PrecomputedStore.open_(tmp_path / "s")
    v, i = DeviceStore(port, layout=layout, device="cpu").search(q, 1)
    assert np.array_equal(i, np.asarray(ij))
    np.testing.assert_allclose(v, np.asarray(vj), rtol=1e-5, atol=1e-5)
    if layout == "gemm":
        vf, jf = JFlatIndex(st.embeddings()).search(q, 3)
        vt, it = FlatIndex(port.embeddings(), on="cpu").search(q, 3)
        assert np.array_equal(it, np.asarray(jf))
        np.testing.assert_allclose(vt, np.asarray(vf), rtol=1e-5, atol=1e-5)
    st.close()
    port.close()


def test_device_store_delta_append_after_writeback_rebuild(tmp_path):
    x = _rows(600)
    st = _write(PrecomputedStore, tmp_path / "s", x, "int8")
    idx = auto_index(st, device="cpu")
    assert isinstance(idx, FlatIndex)
    dev = idx.dev
    u0 = dev.uploads
    assert dev.n_rows == 600 and dev.quantized and dev.layout == "gemm"
    # rebuild over the same store: cached residency, zero new uploads
    idx2 = auto_index(st, device="cpu")
    assert idx2.dev is dev and dev.uploads == u0
    # §3.1 write-back grows the store: only the delta ships
    st.add_batch(x[:50], ["nq"] * 50, ["nr"] * 50)
    st.flush()
    idx3 = auto_index(st, device="cpu")
    assert idx3.dev is dev and cached_device_store(st) is dev
    assert dev.n_rows == 650 and dev.uploads == u0 + 1
    v, i = idx3.search(x[:1], 1)
    assert i[0, 0] == 0
    # shrinking is refused
    with pytest.raises(ValueError):
        dev.sync(_rows(10))
    # another layout gets its own residency
    assert device_store_for(st, layout="kernel", device="cpu") is not dev
    st.close()


def test_auto_index_raises_above_the_flat_tier(tmp_path):
    x = _rows(300)
    st = _write(PrecomputedStore, tmp_path / "s", x, "float16")
    assert select_tier(300, flat_max_rows=100) == "ivf"
    with pytest.raises(NotImplementedError, match="A5"):
        auto_index(st, flat_max_rows=100, device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        auto_index(st, 4, flat_max_rows=100, shard_min_rows=200,
                   device="cpu")
    assert len(auto_index(st, device="cpu")) == 300
    st.close()


def test_cuda_device_refuses_the_gemm_layout():
    """A CUDA device scans with the kernels only: the gemm layout (a
    matmul + top-k in place of B1/B2) is refused there, before any
    upload, and ``auto_index(use_kernel=False)`` cannot reach it."""
    x = _rows(50)
    with pytest.raises(ValueError, match="gemm"):
        DeviceStore(x, layout="gemm", device="cuda")
    with pytest.raises(ValueError, match="gemm"):
        auto_index(x, use_kernel=False, device="cuda")
    assert DeviceStore(x, device="cpu").layout == "gemm"


def test_hash_embedder_bitwise_equal():
    texts = ["what is the height of aurora bridge?", "", "a b c d",
             "sorry to bother you, but who founded the meridian institute?"]
    for dim, seed in [(384, 0), (64, 3)]:
        a = JHashEmbedder(dim=dim, seed=seed).encode(texts)
        b = HashEmbedder(dim=dim, seed=seed).encode(texts)
        assert np.array_equal(a, b)
