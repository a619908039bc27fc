"""The port's copies of ``core/fault_tolerance.py`` (paper §6),
``core/iterative.py`` (paper §9) and ``serving/backend.py``: twins of
``tests/test_fault_tolerance.py``, of ``tests/test_tiered_cache.py::
test_gpu_failure_recovery_reclaims_disk`` on the port's ``PagedKVStore``
and ``DiskSegmentStore``, and of ``tests/test_backend_protocol.py`` for the
port's three backends (``PagedBackend``, ``TorchBackend``,
``_SimBackend``).  Each twin also runs the JAX package's module on the
same calls where the two can meet, and requires the same answers.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.core import fault_tolerance as jax_ft
from repro.core import iterative as jax_iterative
from repro.core.controller import RAGController as JaxController
from repro.core.knowledge_tree import KnowledgeTree as JaxTree
from repro.core.profiler import CostProfiler as JaxCostProfiler
from repro_torch.core import fault_tolerance as torch_ft
from repro_torch.core.controller import RAGController
from repro_torch.core.fault_tolerance import (RetryPolicy,
                                              recover_from_gpu_failure,
                                              replicate_hot_nodes,
                                              serve_with_retry)
from repro_torch.core.iterative import run_iterative
from repro_torch.core.knowledge_tree import CacheBackend, KnowledgeTree, Node
from repro_torch.core.profiler import A10G_MISTRAL_7B, CostProfiler
from repro_torch.kvcache.paged import DiskSegmentStore, PagedKVStore
from repro_torch.serving.backend import Backend, conforms
from repro_torch.serving.engine import TorchBackend
from repro_torch.serving.runtime import PagedBackend
from repro_torch.serving.simulator import _SimBackend


def make_tree(gpu=1000, host=4000, tree_cls=KnowledgeTree,
              prof_cls=CostProfiler):
    return tree_cls(gpu, host, profiler=prof_cls.from_profile(
        A10G_MISTRAL_7B), bytes_per_token=1)


def _hot_and_cold(t, ctl_cls):
    c = ctl_cls(t)
    for _ in range(5):                  # hot chain [1, 2]
        p = c.plan([1, 2], [100, 100], 16)
        c.promote(p)
        c.commit(p)
    p = c.plan([3], [100], 16)          # cold node [3]
    c.promote(p)
    c.commit(p)


def test_hot_node_replication_and_recovery():
    t = make_tree()
    _hot_and_cold(t, RAGController)
    n = replicate_hot_nodes(t, budget_bytes=200)
    assert n == 200            # the two hottest nodes
    t.check_invariants()
    recovered, lost = recover_from_gpu_failure(t)
    assert recovered == 2 and lost == 1
    t.check_invariants()
    # the hot path is still a (host) cache hit; the cold one is gone
    assert len(t.match_prefix([1, 2])) == 2
    assert len(t.match_prefix([3])) == 0


def test_recovery_matches_jax_module():
    """The same tree history through both modules: equal replicated bytes,
    (recovered, lost) and surviving paths."""
    out = []
    for tree_cls, prof_cls, ctl_cls, ft in (
            (KnowledgeTree, CostProfiler, RAGController, torch_ft),
            (JaxTree, JaxCostProfiler, JaxController, jax_ft)):
        t = make_tree(tree_cls=tree_cls, prof_cls=prof_cls)
        _hot_and_cold(t, ctl_cls)
        c = ctl_cls(t)
        p = c.plan([1, 4, 5], [100, 50, 50], 16)
        c.promote(p)
        c.commit(p)
        n = ft.replicate_hot_nodes(t, budget_bytes=250)
        res = ft.recover_from_gpu_failure(t)
        t.check_invariants()
        out.append((n, res, t.gpu_used, t.host_used,
                    [len(t.match_prefix(d)) for d in
                     ([1, 2], [1, 4, 5], [3])]))
    assert out[0] == out[1]


def test_recovery_never_leaves_orphan_children():
    t = make_tree()
    c = RAGController(t)
    p = c.plan([1, 2, 3], [100] * 3, 16)
    c.promote(p)
    c.commit(p)
    # replicate only the root child -> children must be dropped on failure
    replicate_hot_nodes(t, budget_bytes=100)
    recovered, lost = recover_from_gpu_failure(t)
    assert recovered == 1 and lost == 2
    t.check_invariants()


def test_retry_wrapper():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    assert serve_with_retry(flaky, RetryPolicy(max_attempts=3)) == "ok"
    with pytest.raises(RuntimeError):
        serve_with_retry(lambda: 1 / 0, RetryPolicy(max_attempts=2))


def test_iterative_retrieval_extends_prefix():
    """Hop i+1 must hit the whole path hop i inserted (paper §9)."""
    t = make_tree(gpu=10_000, host=10_000)
    c = RAGController(t)
    hops = run_iterative(
        c,
        retrieve_fn=lambda h: [10 + h],
        doc_tokens_fn=lambda d: 100,
        n_hops=3,
        question_tokens=16,
    )
    # hop 0: all new; hop k: k cached docs
    assert [h.alpha for h in hops] == [0, 100, 200]
    assert [len(h.plan.hit_nodes) for h in hops] == [0, 1, 2]
    # a second identical chain is a full hit
    hops2 = run_iterative(c, lambda h: [10 + h], lambda d: 100, 3, 16)
    assert hops2[-1].alpha == 300


def test_iterative_matches_jax_module():
    """Overlapping chains (a doc retrieved again at a later hop is not
    repeated) plan the same alphas and betas through both modules."""
    def retrieve(h):
        return [[3, 7], [7, 9], [1, 3, 4]][h]

    out = []
    for tree_cls, prof_cls, ctl_cls, fn in (
            (KnowledgeTree, CostProfiler, RAGController, run_iterative),
            (JaxTree, JaxCostProfiler, JaxController,
             jax_iterative.run_iterative)):
        t = make_tree(gpu=2_000, host=2_000, tree_cls=tree_cls,
                      prof_cls=prof_cls)
        c = ctl_cls(t)
        hops = fn(c, retrieve, lambda d: 50 + 10 * d, 3, 16)
        hops += fn(c, lambda h: retrieve(2 - h), lambda d: 50 + 10 * d, 3,
                   16)
        out.append([(h.alpha, h.beta, len(h.plan.hit_nodes)) for h in hops])
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# twin of tests/test_tiered_cache.py::test_gpu_failure_recovery_reclaims_disk
# ---------------------------------------------------------------------------

KV_SHAPE = dict(n_layers=2, n_blocks=32, block_size=4, n_kv=2, head_dim=8)
KV_BYTES = 2 * 2 * 2 * 8 * 4            # 2(k,v) * L * KV * hd * f32


def paged_tree(tmp_path, gpu_tokens=10, host_tokens=10, disk_tokens=100):
    store = PagedKVStore(**KV_SHAPE, dtype=torch.float32, device="cpu")
    disk = DiskSegmentStore(str(tmp_path / "kv"), disk_tokens * KV_BYTES)
    tree = KnowledgeTree(gpu_tokens * KV_BYTES, host_tokens * KV_BYTES,
                         disk_tokens * KV_BYTES,
                         backend=PagedBackend(store, disk),
                         bytes_per_token=KV_BYTES)
    return tree, store, disk


def put_doc(tree, store, parent, doc_id, tokens=10):
    rng = np.random.default_rng(doc_id)
    k = rng.normal(size=(2, 1, tokens, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 1, tokens, 2, 8)).astype(np.float32)
    node, _ = tree.insert(parent, doc_id, tokens,
                          store.put(torch.from_numpy(k), torch.from_numpy(v)))
    tree.update_on_access(node, False, 0, tokens)
    return node, k, v


def test_gpu_failure_recovery_reclaims_disk(tmp_path):
    """Device loss with a disk tier: nodes with host/disk replicas survive,
    and slower-tier state stranded under a lost parent is reclaimed, disk
    files included."""
    tree, store, disk = paged_tree(tmp_path, gpu_tokens=30, host_tokens=10,
                                   disk_tokens=40)
    a, ka, va = put_doc(tree, store, tree.root, 1)      # will be replicated
    b, _, _ = put_doc(tree, store, a, 2)                # GPU-only: lost
    c, _, _ = put_doc(tree, store, b, 3)                # pushed to disk
    tree.evict_gpu(10 * KV_BYTES)                       # c -> host
    tree.evict_host(10 * KV_BYTES)                      # c -> disk
    assert c.fastest_tier() == 2 and disk.n_files == 1
    replicate_hot_nodes(tree, 10 * KV_BYTES)            # a gets a host copy
    assert a.in_host
    recovered, lost = recover_from_gpu_failure(tree)
    tree.check_invariants()
    # a survives on host; b is lost (GPU-only), which strands c's disk file
    assert a.in_host and not a.in_gpu
    assert not b.cached and not c.cached
    assert (recovered, lost) == (1, 2)
    assert disk.n_files == 0 and tree.disk_used == 0
    # the survivor's host copy is its device KV, bit for bit
    host = a.payload_host
    assert np.array_equal(host["k"].numpy(), ka)
    assert np.array_equal(host["v"].numpy(), va)


# ---------------------------------------------------------------------------
# twin of tests/test_backend_protocol.py
# ---------------------------------------------------------------------------

def _node():
    return Node(doc_id=0, parent=None, n_tokens=4, bytes_=64)


@pytest.mark.parametrize("make", [
    CacheBackend,
    lambda: PagedBackend(store=None, disk=None),
    lambda: TorchBackend(torch.device("cpu")),
    lambda: _SimBackend(A10G_MISTRAL_7B),
], ids=["base", "paged", "torch", "sim"])
def test_backend_conforms(make):
    """Every implementation satisfies the Protocol (method presence)."""
    assert conforms(make())


def test_protocol_is_runtime_checkable_and_strict():
    """A lookalike missing one hop method must NOT conform."""

    class Almost:
        def swap_out(self, node): return 0.0
        def load(self, node): return 0.0
        def spill(self, node): return 0.0
        def fetch(self, node): return 0.0
        def free_gpu(self, node): pass
        def free_host(self, node): pass
        # free_disk missing
        def demote_copy(self, node, level): return 0.0
        def promote_copy(self, node, level): return 0.0
        def free_tier(self, node, level): pass

    assert not conforms(Almost())
    assert not isinstance(object(), Backend)


def test_base_backend_hops_return_seconds_and_move_payloads():
    b, n = CacheBackend(), _node()
    n.payload_gpu = "seg"
    assert isinstance(b.demote_copy(n, 0), float)    # swap_out
    assert n.payload_host == "seg"
    assert isinstance(b.demote_copy(n, 1), float)    # spill
    assert n.payload_disk == "seg"
    assert b.free_tier(n, 0) is None and n.payload_gpu is None
    assert isinstance(b.promote_copy(n, 2), float)   # fetch
    assert isinstance(b.promote_copy(n, 1), float)   # load
    assert n.payload_gpu == "seg"
    b.free_tier(n, 2)
    assert n.payload_disk is None


def test_torch_backend_hops_return_seconds_and_move_tensors():
    """The sequential engine's backend through the generic dispatch: host
    copies equal the device tensors, frees return None."""
    b, n = TorchBackend(torch.device("cpu")), _node()
    kv = {"k": torch.arange(8.0), "v": torch.ones(8)}
    n.payload_gpu = kv
    assert isinstance(b.demote_copy(n, 0), float)
    assert torch.equal(n.payload_host["k"], kv["k"])
    assert b.free_tier(n, 0) is None and n.payload_gpu is None
    assert isinstance(b.promote_copy(n, 1), float)
    assert torch.equal(n.payload_gpu["v"], kv["v"])


def test_sim_backend_hop_costs_are_analytic_transfer_times():
    prof = A10G_MISTRAL_7B
    b = _SimBackend(prof)
    small, big = _node(), _node()
    small.bytes_, big.bytes_ = 2**20, 2**24
    small.payload_gpu = big.payload_gpu = object()
    assert b.swap_out(big) > b.swap_out(small) > 0.0
    b2 = _SimBackend(prof.with_tp(2))
    assert b2.swap_out(big) < b.swap_out(big)   # tp-parallel shard copies
