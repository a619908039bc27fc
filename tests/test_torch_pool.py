"""The port's paged KV pool behaves as the JAX package's: the same block
accounting for put / append / extend_alloc / gather / share / share_blocks
/ release on the same inputs, writes land in the pool tensors in place,
and a bf16 segment survives device -> host -> disk -> device bit for bit
(numpy has no bf16, so the disk tier stores raw bytes)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.kvcache.paged import PagedKVStore as JaxStore
from repro_torch.core.knowledge_tree import Node
from repro_torch.kvcache.paged import (DiskSegmentStore, OutOfBlocks,
                                       PagedKVStore, to_host)
from repro_torch.serving.runtime import PagedBackend

L, NB, BS, KV, HD = 2, 10, 4, 2, 8


def _seg(rng, T):
    return rng.standard_normal((L, 1, T, KV, HD)).astype(np.float32)


def _stores():
    j = JaxStore(L, NB, BS, KV, HD, dtype=jnp.float32, device=True)
    t = PagedKVStore(L, NB, BS, KV, HD, dtype=torch.float32, device="cpu")
    return j, t


def _same_pool(j, t):
    assert j.pool._free == t.pool._free
    assert np.array_equal(j.pool._ref, t.pool._ref)
    t.pool.check()


def _gathered_equal(j, js, t, ts):
    jk, jv = j.gather(js)
    tk, tv = t.gather(ts)
    assert np.array_equal(np.asarray(jk), tk.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())


def test_store_ops_match_jax_store():
    rng = np.random.default_rng(0)
    j, t = _stores()
    k_obj, v_obj = t.k_planes[0], t.v_planes[0]
    a, b = _seg(rng, 6), _seg(rng, 6)
    js = j.put(jnp.asarray(a), jnp.asarray(b), reserve_tokens=3)
    ts = t.put(torch.from_numpy(a), torch.from_numpy(b), reserve_tokens=3)
    assert js.blocks == ts.blocks and js.n_tokens == ts.n_tokens
    _gathered_equal(j, js, t, ts)
    _same_pool(j, t)
    # append fills the tail slots, then allocates
    c, d = _seg(rng, 7), _seg(rng, 7)
    j.append(js, jnp.asarray(c), jnp.asarray(d))
    t.append(ts, torch.from_numpy(c), torch.from_numpy(d))
    assert js.blocks == ts.blocks and ts.n_tokens == 13
    _gathered_equal(j, js, t, ts)
    # extend_alloc hands out coordinates only
    assert [x.tolist() for x in j.extend_alloc(js, 5)] == \
        [x.tolist() for x in t.extend_alloc(ts, 5)]
    assert js.blocks == ts.blocks
    _same_pool(j, t)
    # sharing and release
    for s in (j, t):
        seg = js if s is j else ts
        s.share(seg)
        s.share_blocks(seg.blocks[:2])
        s.release(seg.blocks[:2])
    _same_pool(j, t)
    j.free(js)
    t.free(ts)
    j.free(js)
    t.free(ts)
    _same_pool(j, t)
    assert t.pool.free_blocks == NB                  # nothing leaked
    assert t.k_planes[0] is k_obj and t.v_planes[0] is v_obj  # in place


def test_out_of_blocks_leaves_segment_unchanged():
    rng = np.random.default_rng(1)
    _, t = _stores()
    seg = t.put(torch.from_numpy(_seg(rng, 5)), torch.from_numpy(_seg(rng, 5)))
    blocks = list(seg.blocks)
    with pytest.raises(OutOfBlocks):
        t.extend_alloc(seg, BS * NB)
    assert seg.blocks == blocks and seg.n_tokens == 5
    t.free(seg)
    assert t.pool.free_blocks == NB


def test_bf16_segment_round_trips_bit_for_bit(tmp_path):
    """device -> host -> disk -> device through the tier backend."""
    g = torch.Generator().manual_seed(3)
    store = PagedKVStore(L, NB, BS, KV, HD, dtype=torch.bfloat16)
    k = torch.randn((L, 1, 9, KV, HD), generator=g).to(torch.bfloat16)
    v = torch.randn((L, 1, 9, KV, HD), generator=g).to(torch.bfloat16)
    disk = DiskSegmentStore(str(tmp_path))
    backend = PagedBackend(store, disk)
    node = Node(doc_id=0, parent=None, n_tokens=9)
    node.payload_gpu = store.put(k, v)
    backend.swap_out(node)                         # device -> host
    backend.spill(node)                            # host -> disk
    assert disk.n_files == 1
    assert disk.used_bytes == 2 * k.numel() * k.element_size()
    backend.free_gpu(node)
    node.payload_host = None
    backend.fetch(node)                            # disk -> host
    backend.load(node)                             # host -> device
    k2, v2 = store.gather(node.payload_gpu)
    assert k2.dtype == torch.bfloat16
    assert torch.equal(k2.view(torch.int16), k.view(torch.int16))
    assert torch.equal(v2.view(torch.int16), v.view(torch.int16))
    backend.free_disk(node)
    backend.free_gpu(node)
    assert disk.n_files == 0 and disk.used_bytes == 0
    assert store.pool.free_blocks == NB


def test_to_host_copies():
    x = torch.arange(6.0)
    h = to_host(x)
    x += 1
    assert torch.equal(h, torch.arange(6.0))
