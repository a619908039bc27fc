"""Sequential RAG serving engine (counterpart of ``repro.serving.engine``):
one request at a time through the full RAGCache pipeline — staged vector
search, knowledge-tree lookup, host->device promotion, segment-chained
dense prefix prefill, greedy decode over a dense cache, and PGDSF-managed
insertion of the newly computed document KV.

It is the single-device token oracle that ``--check-tokens`` holds the
continuous runtime against, and the engine that serves the recurrent
families.  Document payloads:

  * attention families: per-document {k, v} tensors of shape (L, 1, T, KV,
    hd): on the device in the GPU tier, CPU tensors (pinned for a CUDA
    device) in the host tier, one raw-byte file each in the optional disk
    tier;
  * ssm (xLSTM): the recurrent state snapshot after the document, the
    model's nested state; only the deepest hit node's state is promoted
    into the prefix.  The tree bills it at 4 B a token, as the reference
    does, whatever its real size;
  * hybrid (Hymba): both, the {k, v} segment and "ssm", the SSM state after
    the document.

Recurrent snapshots have no disk tier.  A snapshot is the very tensor the
model step produced and the next segment reads: no step writes a state
tensor it was given (``models.model``), so a tree hit replays the cold
run's calls on the same bits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.controller import RAGController
from repro_torch.core.knowledge_tree import CacheBackend, KnowledgeTree
from repro_torch.core.profiler import CostProfiler
from repro_torch.core.reorder import ReorderQueue
from repro_torch.core.speculative import SpecState, SpeculativeController
from repro_torch.kvcache.paged import make_disk_store
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.retrieval.corpus import Corpus, Request
from repro_torch.serving.config import EngineConfig, reject_legacy_kwargs
from repro_torch.launch.sharding import shard_params
from repro_torch.serving.runtime import pinned, resolve_device, sync
from repro_torch.serving.scheduler import prefill_piece_sizes


def tree_map(fn, payload):
    """``fn`` over every tensor of a nested payload (dicts, tuples, None),
    keeping its structure."""
    if isinstance(payload, dict):
        return {key: tree_map(fn, v) for key, v in payload.items()}
    if isinstance(payload, (tuple, list)):
        return type(payload)(tree_map(fn, v) for v in payload)
    return None if payload is None else fn(payload)


class TorchBackend(CacheBackend):
    """Device tier: tensors on the engine's device; host tier: CPU copies
    (pinned for a CUDA device, so the promote back is an asynchronous
    copy); optional disk tier: one raw-byte file per node ({k, v}
    payloads only).  Payloads may nest (the xLSTM state).  Transfer
    seconds are measured, each hop ending in a device synchronise."""

    def __init__(self, device: torch.device, disk=None):
        self.device = device
        self.disk = disk

    def swap_out(self, node):
        t0 = time.perf_counter()
        node.payload_host = tree_map(lambda t: pinned(t.cpu(), self.device),
                                     node.payload_gpu)
        return time.perf_counter() - t0

    def load(self, node):
        t0 = time.perf_counter()
        node.payload_gpu = tree_map(
            lambda t: t.to(self.device, non_blocking=True),
            node.payload_host)
        sync(self.device)
        return time.perf_counter() - t0

    def spill(self, node):
        t0 = time.perf_counter()
        node.payload_disk = self.disk.write(node.payload_host["k"],
                                            node.payload_host["v"])
        return time.perf_counter() - t0

    def fetch(self, node):
        t0 = time.perf_counter()
        k, v = self.disk.read(node.payload_disk)
        node.payload_host = {"k": pinned(k, self.device),
                             "v": pinned(v, self.device)}
        return time.perf_counter() - t0

    def free_disk(self, node):
        if node.payload_disk is not None:
            self.disk.delete(node.payload_disk)
        node.payload_disk = None


@dataclasses.dataclass
class ServeResult:
    req_id: int
    tokens: List[int]
    ttft: float
    search_time: float
    transfer_time: float
    prefill_time: float
    alpha: int
    beta: int
    docs: Tuple[int, ...]
    # (V,) logits at the first generated token — the sequential engine is
    # the oracle --check-tokens tol:<eps> measures divergence against
    first_logits: Optional[np.ndarray] = None


class RAGServer:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        corpus: Corpus,
        index,
        *,
        config: Optional[EngineConfig] = None,
        reorder_window: int = 32,
        profiler: Optional[CostProfiler] = None,
        device=None,
        mesh=None,
        **legacy,
    ):
        # ``config=`` is the sole constructor API (serving/config.py).  The
        # sequential engine ignores config.mesh and the attention options:
        # it is the single-device dense oracle.  ``device``: None resolves
        # to CUDA and raises without it; the CPU runs only when asked for.
        # ``mesh``: a one-device mesh whose column-slab group
        # (launch/mesh.py) is a tensor-parallel serve's, so the oracle
        # computes that serve's bits; None serves unslabbed.
        reject_legacy_kwargs("RAGServer", legacy, EngineConfig)
        config = config if config is not None else EngineConfig()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        self.params = (params if mesh is None
                       else shard_params(params, cfg, mesh))
        self.corpus = corpus
        self.index = index
        self.top_k = config.top_k
        self.attn_impl = config.attn_impl
        # tokens per prefill call (0 = one call per segment), split per
        # segment by the shared splitter, as the continuous runtime does
        self.prefill_chunk = config.prefill_chunk
        kv_bytes = (2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd
                    * cfg.tdtype.itemsize)
        disk_cache_bytes = config.disk_cache_bytes
        if cfg.family == "ssm":
            kv_bytes = 4  # state nodes are O(1); bill ~per-token trivially
        if cfg.family in M.RECURRENT:
            disk_cache_bytes = 0   # recurrent snapshots are not {k, v} dicts
        self.mode = config.mode
        if self.mode == "cag" and disk_cache_bytes <= 0:
            raise ValueError(
                "mode='cag' preloads the whole corpus KV into the disk tier "
                "and needs disk_cache_bytes > 0 sized for the corpus"
                + (" (recurrent-state families have no disk tier)"
                   if cfg.family in M.RECURRENT else ""))
        self.disk = make_disk_store(config.disk_cache_dir, disk_cache_bytes)
        self.tree = KnowledgeTree(
            config.gpu_cache_bytes, config.host_cache_bytes,
            disk_cache_bytes if self.disk is not None else 0,
            policy=config.policy,
            profiler=profiler or CostProfiler.from_fn(
                lambda a, b: 1e-4 * b + 2e-8 * b * (a + b),
                (0, 64, 256, 1024), (1, 32, 128, 512, 1024)),
            backend=TorchBackend(self.device, self.disk),
            bytes_per_token=max(kv_bytes, 1),
        )
        self.controller = RAGController(self.tree)
        self.spec_ctl = SpeculativeController(config.max_prefill_bs,
                                              enabled=config.speculative)
        self.reorder = ReorderQueue(reorder_window, enabled=config.reorder)
        self.results: List[ServeResult] = []
        # CAG start-up: pre-insert the FULL corpus KV into the disk tier,
        # each doc computed at position 0 with no prefix (what the engine
        # computes for a doc served first)
        self.preload_stats: Optional[dict] = None
        if self.mode == "cag":
            self.preload_stats = self.controller.preload_corpus(
                range(len(corpus.doc_lengths)), corpus.doc_lengths,
                self._corpus_payload)

    def _tokens(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64),
                               device=self.device)[None]

    def _corpus_payload(self, doc_id: int, n_tokens: int) -> dict:
        """Host-layout {k, v} KV of one corpus doc as CPU tensors, computed
        standalone (position 0, no prefix) through the engine's prefill."""
        toks = self.corpus.doc_tokens[doc_id]
        _, cache, _ = self._prefill_segment(toks, None, 0)
        seg = self._extract_payload(cache, 0, len(toks))
        return {key: t.cpu() for key, t in seg.items()}

    # ---- payload plumbing -------------------------------------------------

    def _assemble_prefix(self, nodes) -> Tuple[Optional[dict], int]:
        """Concatenate hit-node payloads into a model prefix_cache; of a
        recurrent state only the deepest node's matters."""
        if not nodes:
            return None, 0
        if self.cfg.family == "ssm":
            return nodes[-1].payload_gpu, sum(n.n_tokens for n in nodes)
        ks = torch.cat([n.payload_gpu["k"] for n in nodes], dim=2)
        vs = torch.cat([n.payload_gpu["v"] for n in nodes], dim=2)
        out = {"k": ks, "v": vs}
        if self.cfg.family == "hybrid":
            out["ssm"] = nodes[-1].payload_gpu["ssm"]
        return out, int(ks.shape[2])

    # ---- serving ------------------------------------------------------------

    def serve(self, requests: Sequence[Request],
              max_new_tokens: int = 4) -> List[ServeResult]:
        # cache-aware reordering over the (logical) arrival queue
        for r in requests:
            docs = tuple(self.index.search(r.query_vec, self._top_k_of(r)))
            hit = self.tree.match_prefix(docs)
            cached = sum(n.n_tokens for n in hit)
            total = sum(int(self.corpus.doc_lengths[d]) for d in docs) \
                + len(r.question_tokens)
            self.reorder.push((r, docs), cached, max(total - cached, 1))
        out = []
        while True:
            self.reorder.refresh(self._refresh_lens)
            item = self.reorder.pop()
            if item is None:
                break
            out.append(self._serve_one(*item, max_new_tokens=max_new_tokens))
        self.results.extend(out)
        return out

    def _top_k_of(self, r: Request) -> int:
        """Per-request retrieval depth: Request.top_k > 0 overrides (only
        ever lowering it), as the continuous runtime honours it."""
        return min(r.top_k, self.top_k) if r.top_k > 0 else self.top_k

    def _refresh_lens(self, item):
        r, docs = item
        hit = self.tree.match_prefix(docs)
        cached = sum(n.n_tokens for n in hit)
        total = sum(int(self.corpus.doc_lengths[d]) for d in docs) \
            + len(r.question_tokens)
        return cached, max(total - cached, 1)

    def _serve_one(self, r: Request, docs: Tuple[int, ...],
                   max_new_tokens: int) -> ServeResult:
        # 1. staged retrieval + speculative-pipelining decisions (logical);
        #    CAG runs ZERO retrieval stages: the docs were resolved by the
        #    one index probe at arrival, and search_time is 0
        search_time = 0.0
        if self.mode != "cag":
            t0 = time.perf_counter()
            spec = SpecState(r.req_id)
            for stage in self.index.staged_search(r.query_vec,
                                                  self._top_k_of(r)):
                self.spec_ctl.on_stage(spec, tuple(stage.topk), 0,
                                       is_final=stage.is_final)
            search_time = time.perf_counter() - t0

        doc_tokens = [int(self.corpus.doc_lengths[d]) for d in docs]
        plan = self.controller.plan(docs, doc_tokens, len(r.question_tokens))
        transfer = self.controller.promote(plan)

        # 2. segment-chained prefill: cached prefix -> each uncached doc ->
        #    question; each uncached doc's KV becomes a tree payload
        t1 = time.perf_counter()
        prefix, plen = self._assemble_prefix(plan.hit_nodes)
        payloads = []
        for i in range(len(plan.hit_nodes), len(docs)):
            toks = self.corpus.doc_tokens[docs[i]]
            start = plen
            _, prefix, plen = self._prefill_segment(toks, prefix, plen)
            payloads.append(self._extract_payload(prefix, start, len(toks)))
        logits, cache, plen = self._prefill_segment(
            r.question_tokens, prefix, plen)
        first = logits[0, -1]
        toks = [int(first.argmax())]
        first_logits = first.cpu().numpy()
        sync(self.device)
        prefill_time = time.perf_counter() - t1

        # 3. commit new doc KV to the knowledge tree (PGDSF update)
        self.controller.commit(plan, payloads)

        # 4. greedy decode
        total_len = plen
        if max_new_tokens > 1:
            toks += self._decode(cache, toks[0], total_len, max_new_tokens - 1)
        ttft = search_time + transfer + prefill_time
        return ServeResult(
            req_id=r.req_id, tokens=toks, ttft=ttft,
            search_time=search_time, transfer_time=transfer,
            prefill_time=prefill_time, alpha=plan.alpha, beta=plan.beta,
            docs=docs, first_logits=first_logits,
        )

    def _prefill_segment(self, tokens, prefix, plen: int):
        """Prefill one segment (document or question) on top of ``prefix``,
        in ``prefill_chunk``-token pieces (one call for the whole segment
        when chunking is off).  Returns (last_logits, cache, new_plen)."""
        logits = None
        off = 0
        for n in prefill_piece_sizes([len(tokens)], self.prefill_chunk):
            logits, cache = M.prefill(self.cfg, self.params,
                                      self._tokens(tokens[off:off + n]),
                                      prefix, plen, attn_impl=self.attn_impl,
                                      mesh=self.mesh)
            prefix, plen = cache, plen + n
            off += n
        # a zero-length segment runs no pieces: keep the prefix chain
        return logits, prefix, plen

    def _extract_payload(self, cache, start: int, length: int) -> dict:
        if self.cfg.family == "ssm":
            return dict(cache)                           # state snapshot
        # a copy, not a view: a view would keep the whole sequence's cache
        # alive in the tree
        seg = {key: cache[key][:, :, start:start + length].clone()
               for key in ("k", "v")}
        if self.cfg.family == "hybrid":
            seg["ssm"] = cache["ssm"]
        return seg

    def _decode(self, cache, last_tok: int, cur_len: int,
                n: int) -> List[int]:
        if self.cfg.family == "ssm":
            # a dict of its own: the decode steps replace its entries
            dc = dict(cache)
        else:
            dc = M.init_decode_cache(self.cfg, 1, cur_len + n + 1,
                                     device=self.device)
            dc["k"][:, :, :cur_len] = cache["k"]
            dc["v"][:, :, :cur_len] = cache["v"]
            if self.cfg.family == "hybrid":
                dc["ssm"] = cache["ssm"]
        out = []
        pos = torch.tensor([cur_len], dtype=torch.int32, device=self.device)
        tok = self._tokens([last_tok])
        for _ in range(n):
            pos = pos + 1
            logits = M.decode_step(self.cfg, self.params, tok, dc, pos,
                                   mesh=self.mesh)
            t = int(logits[0, -1].argmax())
            out.append(t)
            tok = self._tokens([t])
        return out
