"""The port's retrieval core against the JAX reference on the CPU: one
store, searched by the reference ``FlatIndex`` / ``DeviceStore`` and by
the port's (fp32, fp16, int8 stores; "kernel" and "gemm" layouts), the
upload-once ``DeviceStore`` with delta appends, the IVF tier (a fit saved
by either package loads in the other and returns identical ids; the
port's own fit held to ``recall_vs_flat``), ``auto_index`` tier selection
with the persisted fit and the sharded tier on a mesh of CPU shards, the
hash embedder, and the shared on-disk store format."""
import numpy as np
import pytest

from repro.core.embedder import HashEmbedder as JHashEmbedder
from repro.core.index import DeviceStore as JDeviceStore
from repro.core.index import FlatIndex as JFlatIndex
from repro.core.index import IVFIndex as JIVFIndex
from repro.core.index import auto_index as jauto_index
from repro.core.store import PrecomputedStore as JStore
from repro_torch.core.embedder import HashEmbedder
from repro_torch.core.index import (IVF_CACHE_NAME, DeviceStore, FlatIndex,
                                    IVFIndex, ShardedIndex, auto_index,
                                    cached_device_store, device_store_for,
                                    ivf_params, kmeans, select_tier)
from repro_torch.core.store import PrecomputedStore
from repro_torch.launch.mesh import make_mesh


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
    """Above the flat tier ``auto_index`` builds the IVF tier; on a mesh
    whose model axis is above 1 it builds the sharded tier from
    ``shard_min_rows``, which answers as the flat search does."""
    x = _rows(300)
    st = _write(PrecomputedStore, tmp_path / "s", x, "float16")
    assert select_tier(300, flat_max_rows=100) == "ivf"
    idx = auto_index(st, flat_max_rows=100, device="cpu")
    assert isinstance(idx, IVFIndex) and len(idx) == 300
    assert (idx.n_lists, idx.nprobe) == ivf_params(300)
    assert cached_device_store(st) is None     # no flat copy was pinned
    mesh = make_mesh((4,), ("model",), devices=["cpu"] * 4)
    sh = auto_index(st, mesh, flat_max_rows=100, shard_min_rows=200,
                    device="cpu")
    assert isinstance(sh, ShardedIndex) and len(sh) == 300
    q = _queries(x)
    flat = auto_index(st, device="cpu")
    assert isinstance(flat, FlatIndex)
    v, i = sh.search(q, 4)
    fv, fi = flat.search(q, 4)
    np.testing.assert_array_equal(i, fi)
    np.testing.assert_allclose(v, fv, rtol=1e-5, atol=1e-6)
    st.close()


def _clustered(n, d=48, n_centers=16, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    x = (centers[rng.integers(0, n_centers, n)]
         + 0.1 * rng.normal(size=(n, d)).astype(np.float32))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("emb_dtype", ["float32", "float16", "int8"])
def test_ivf_loads_the_reference_fit_and_returns_identical_ids(
        tmp_path, emb_dtype):
    """A fit the reference ``IVFIndex.save`` wrote loads in the port (the
    same ``.npz``, fingerprint checked) and searches to identical ids;
    the port's own ``save`` loads in the reference just as well."""
    x = _clustered(1200)
    st = _write(JStore, tmp_path / "s", x, emb_dtype)
    q = _queries(x)
    jidx = JIVFIndex(st.embeddings(), n_lists=16, nprobe=4)
    jidx.save(tmp_path / "j.npz")
    port = PrecomputedStore.open_(tmp_path / "s")
    idx = IVFIndex.load(tmp_path / "j.npz", port.embeddings(), on="cpu")
    assert idx.loaded_from == str(tmp_path / "j.npz")
    assert (idx.n_total, idx.n_lists, idx.nprobe) == (1200, 16, 4)
    for k in (1, 5):
        vj, ij = jidx.search(q, k)
        v, i = idx.search(q, k)
        assert np.array_equal(i, np.asarray(ij))
        np.testing.assert_allclose(v, np.asarray(vj), rtol=1e-5, atol=1e-5)
    assert np.array_equal(idx.reconstruct(), np.asarray(jidx.reconstruct()))
    idx.save(tmp_path / "p.npz")
    back = JIVFIndex.load(tmp_path / "p.npz", st.embeddings())
    assert np.array_equal(np.asarray(back.ids), np.asarray(jidx.ids))
    assert np.array_equal(np.asarray(back.search(q, 3)[1]),
                          np.asarray(jidx.search(q, 3)[1]))
    st.close()
    port.close()


def test_ivf_fingerprint_mismatch_raises(tmp_path):
    """A fit belongs to the content it was fitted on: the same row count
    with other vectors is refused by ``load`` and refitted by
    ``auto_index``."""
    a = _write(PrecomputedStore, tmp_path / "a", _clustered(400, seed=1),
               "float16")
    b = _write(PrecomputedStore, tmp_path / "b", _clustered(400, seed=2),
               "float16")
    IVFIndex(a.embeddings(), n_lists=8, nprobe=2, on="cpu").save(
        tmp_path / "b" / IVF_CACHE_NAME)
    with pytest.raises(ValueError, match="different store content"):
        IVFIndex.load(tmp_path / "b" / IVF_CACHE_NAME, b.embeddings(),
                      on="cpu")
    idx = auto_index(b, flat_max_rows=100, cache_dir=tmp_path / "b",
                     device="cpu")
    assert idx.loaded_from is None
    again = auto_index(b, flat_max_rows=100, cache_dir=tmp_path / "b",
                       device="cpu")
    assert again.loaded_from == str(tmp_path / "b" / IVF_CACHE_NAME)
    a.close()
    b.close()


def test_ivf_own_fit_recall_vs_flat():
    """The port's own k-means (its seeding cannot be the reference's) held
    to the exact flat scan, as the reference's test holds its fit."""
    rng = np.random.default_rng(3)
    x = _clustered(1500)
    q = x[rng.choice(1500, 40)]
    ivf = IVFIndex(x, n_lists=16, nprobe=6, on="cpu")
    assert ivf.lists.shape[:2] == ivf.ids.shape and ivf.cap >= 1500 // 16
    assert sorted(ivf.ids[ivf.ids >= 0].tolist()) == list(range(1500))
    r = ivf.recall_vs_flat(q, k=10)
    assert 0.8 < r <= 1.0, r
    full = IVFIndex(x, n_lists=16, nprobe=16, on="cpu")
    assert full.recall_vs_flat(q, k=10) == 1.0
    np.testing.assert_array_equal(full.reconstruct(), x)


def test_kmeans_clamps_lists_to_the_row_count():
    import torch
    x = torch.from_numpy(_clustered(10))
    cent, assign = kmeans(x, 64, iters=3)
    assert cent.shape == (10, 48) and assign.shape == (10,)
    cent, assign = kmeans(x, 4, iters=5, seed=1)
    assert cent.shape == (4, 48) and int(assign.max()) < 4


def test_auto_index_reuses_a_matching_reference_cache(tmp_path):
    """The reference's ``auto_index(cache_dir=...)`` writes
    ``index_ivf.npz`` into the store root; the port's ``auto_index`` with
    the same ``cache_dir`` loads it (no k-means) and agrees on ids; a store
    that grew is refitted and the cache rewritten."""
    x = _clustered(500, seed=4)
    st = _write(JStore, tmp_path / "s", x, "float16")
    jidx = jauto_index(st, flat_max_rows=100, cache_dir=tmp_path / "s")
    assert (tmp_path / "s" / IVF_CACHE_NAME).exists()
    port = PrecomputedStore.open_(tmp_path / "s")
    idx = auto_index(port, flat_max_rows=100, cache_dir=tmp_path / "s",
                     device="cpu")
    assert isinstance(idx, IVFIndex)
    assert idx.loaded_from == str(tmp_path / "s" / IVF_CACHE_NAME)
    q = _queries(x)
    assert np.array_equal(idx.search(q, 1)[1], np.asarray(jidx.search(q,
                                                                      1)[1]))
    port.add_batch(x[:30], ["nq"] * 30, ["nr"] * 30)
    port.flush()
    grown = auto_index(port, flat_max_rows=100, cache_dir=tmp_path / "s",
                       device="cpu")
    assert grown.loaded_from is None and len(grown) == 530
    assert IVFIndex.load(tmp_path / "s" / IVF_CACHE_NAME,
                         port.embeddings(), on="cpu").n_total == 530
    st.close()
    port.close()


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
