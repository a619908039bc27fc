"""The recurrent scans' backward recomputes chunk by chunk, as the
reference's does (``mlstm_chunkwise``'s ``jax.checkpoint(chunk_body)``,
``slstm_scan``'s and ``mamba_scan``'s ``chunked_scan(..., remat=True)``),
on the CPU in f32 at reduced widths, with S of three chunks and a ragged
tail (the reference pads the tail with masked steps, the port runs a short
last chunk: the same carries).

- Outputs, final states and the grads of every input under
  ``jax.value_and_grad`` of the same loss: within SCAN_TOL x max(1, max
  |reference|), the scans' tolerance in ``test_torch_recurrent.py``.
- Against the port's unchunked form (``chunk`` >= S; for the chunkwise
  mLSTM, whose chunk is part of its arithmetic, the same chunks without
  the checkpoint): outputs, states and grads bit for bit, but for
  ``mamba_scan``'s A, whose grad sums over a chunk's steps (the chunk's
  decay is computed at once) and then over chunks: within A_GRAD_RTOL x
  max |grad|.
- What autograd keeps for the backward: each extra chunk adds its carries
  and its inputs and nothing else; the unchunked form keeps every step's
  intermediates.
- Without autograd the scans give the parent's bits (its loops, copied
  below).
- The compile analysis (fake tensors) counts the recompute: the FLOPs of
  a chunked backward are the unchunked one's plus one forward, equal to
  the real loops', and its peak is lower.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.models import layers as JL
from repro_torch.launch import op_analysis
from repro_torch.models import layers as L

torch.set_num_threads(2)

SCAN_TOL = 1e-4
A_GRAD_RTOL = 1e-5
CHUNK = 32
S_RAGGED = 3 * CHUNK + 11
B, H, HD, N = 2, 2, 8, 4
SCANS = ("mlstm_chunkwise", "slstm_scan", "mamba_scan")


def _inputs(name, S, seed=0, with_state=False):
    """numpy inputs (and a state or None) of the scan ``name``."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    if name == "mlstm_chunkwise":
        ins = [normal(B, S, H, HD) for _ in range(3)]
        ins += [normal(B, S, H), (3.0 + normal(B, S, H))]
        st = (normal(B, H, HD, HD), normal(B, H, HD), normal(B, H)) \
            if with_state else None
    elif name == "slstm_scan":
        ins = [normal(B, S, H, 4 * HD), normal(H, HD, 4 * HD, scale=0.3)]
        st = (normal(B, H, HD), 1.0 + np.abs(normal(B, H, HD)),
              normal(B, H, HD), normal(B, H, HD)) if with_state else None
    else:
        ins = [normal(B, S, H, HD),
               np.abs(normal(B, S, H, scale=0.1)),
               -np.exp(normal(H, HD, N)), normal(B, S, N), normal(B, S, N),
               normal(H, HD)]
        st = normal(B, H, HD, N) if with_state else None
    return ins, st


def _cotangents(name, S, with_state):
    """Fixed random weights of the loss: sum(out * w) + sum(state * w)."""
    outs, st = _inputs(name, S, seed=99, with_state=True)
    out = {"mlstm_chunkwise": outs[0], "slstm_scan": outs[0][..., :HD],
           "mamba_scan": outs[0]}[name]
    return out, (st if isinstance(st, tuple) else (st,))


def _port(name, ins, st, chunk):
    fn = getattr(L, name)
    if name == "mamba_scan":
        y, s = fn(*ins, state=st, chunk=chunk)
        return y, (s,)
    if name == "slstm_scan":
        return fn(*ins, st, chunk=chunk)
    return fn(*ins, state=st, chunk=chunk)


def _port_grads(name, ins, st, chunk, S):
    """(out, states, grads of the inputs and of the state) of the port."""
    wo, ws = _cotangents(name, S, st is not None)
    tins = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    tst = None if st is None else (
        tuple(torch.from_numpy(a).requires_grad_(True) for a in st)
        if isinstance(st, tuple)
        else torch.from_numpy(st).requires_grad_(True))
    out, states = _port(name, tins, tst, chunk)
    loss = (out * torch.from_numpy(wo)).sum() + sum(
        (s * torch.from_numpy(w)).sum() for s, w in zip(states, ws))
    given = tins + ([] if tst is None else list(
        tst if isinstance(tst, tuple) else (tst,)))
    grads = torch.autograd.grad(loss, given)
    return out.detach(), [s.detach() for s in states], list(grads)


def _jax_grads(name, ins, st, chunk, S):
    wo, ws = _cotangents(name, S, st is not None)
    fn = getattr(JL, name)

    def loss(args):
        xs, state = args
        if name == "slstm_scan":
            out, states = fn(*xs, state, chunk=chunk)
        else:
            out, states = fn(*xs, state=state, chunk=chunk)
        states = states if isinstance(states, tuple) else (states,)
        val = jnp.sum(out * wo) + sum(jnp.sum(s * w)
                                      for s, w in zip(states, ws))
        return val, (out, states)

    (_, (out, states)), g = jax.value_and_grad(loss, has_aux=True)(
        (list(ins), st))
    gst = [] if st is None else list(g[1] if isinstance(g[1], tuple)
                                     else (g[1],))
    return out, list(states), list(g[0]) + gst


def _close(got, want, what):
    a, b = got.numpy(), np.asarray(want)
    assert a.shape == b.shape, what
    err, top = np.max(np.abs(a - b)), np.max(np.abs(b))
    assert np.isfinite(err) and err <= SCAN_TOL * max(1.0, top), (what, err,
                                                                  top)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("name", SCANS)
def test_scan_value_and_grad_match_jax(name, with_state):
    ins, st = _inputs(name, S_RAGGED, seed=1, with_state=with_state)
    out, states, grads = _port_grads(name, ins, st, CHUNK, S_RAGGED)
    jout, jstates, jgrads = _jax_grads(name, ins, st, CHUNK, S_RAGGED)
    _close(out, jout, "out")
    for i, (a, b) in enumerate(zip(states, jstates)):
        _close(a, b, f"state {i}")
    assert len(grads) == len(jgrads)
    for i, (a, b) in enumerate(zip(grads, jgrads)):
        _close(a, b, f"grad {i}")


def _no_checkpoint(f, *args, **_):
    return f(*args)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("name", SCANS)
def test_chunked_equals_unchunked_bit_for_bit(name, with_state,
                                              monkeypatch):
    ins, st = _inputs(name, S_RAGGED, seed=2, with_state=with_state)
    got = _port_grads(name, ins, st, CHUNK, S_RAGGED)
    if name == "mlstm_chunkwise":
        monkeypatch.setattr(L, "checkpoint", _no_checkpoint)
        want = _port_grads(name, ins, st, CHUNK, S_RAGGED)
    else:
        want = _port_grads(name, ins, st, S_RAGGED, S_RAGGED)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    for i, (a, b) in enumerate(zip(got[2], want[2])):
        if name == "mamba_scan" and i == 2:        # A
            top = b.abs().max().item()
            assert (a - b).abs().max().item() <= A_GRAD_RTOL * top
        else:
            assert torch.equal(a, b), (name, i)


def _kept(name, n_chunks, chunk, monkeypatch, remat=True):
    """Elements autograd keeps for the backward of the scan over
    ``n_chunks`` whole chunks: the tensors it saves outside checkpoints and
    the checkpoints' tensor inputs, each view counted once."""
    S = n_chunks * chunk
    ins, _ = _inputs(name, S, seed=3)
    tins = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    kept = {}

    def key(t):
        return (t.untyped_storage().data_ptr(), t.storage_offset(),
                tuple(t.shape))

    def pack(t):
        kept[key(t)] = t.numel()
        return t

    real = L.checkpoint

    def spy(f, *args, **kw):
        for a in args:
            for t in (a if isinstance(a, tuple) else (a,)):
                kept[key(t)] = t.numel()
        return real(f, *args, **kw)

    monkeypatch.setattr(L, "checkpoint", spy if remat else _no_checkpoint)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out, _ = _port(name, tins, None, chunk if remat else S)
    monkeypatch.setattr(L, "checkpoint", real)
    out.sum().backward()
    return sum(kept.values())


def _per_chunk(name, chunk):
    """A chunk's carries and inputs, in elements."""
    if name == "mlstm_chunkwise":
        carry = B * H * HD * HD + B * H * HD + B * H
        inputs = 3 * B * chunk * H * HD + 2 * B * chunk * H
    elif name == "slstm_scan":
        carry, inputs = 4 * B * H * HD, B * chunk * H * 4 * HD
    else:
        carry = B * H * HD * N
        inputs = B * chunk * H * HD + B * chunk * H + 2 * B * chunk * N
    return carry + inputs


@pytest.mark.parametrize("name", SCANS)
def test_backward_keeps_carries_and_inputs_per_chunk(name, monkeypatch):
    chunk = 16
    kept = [_kept(name, n, chunk, monkeypatch) for n in (2, 3, 4)]
    step = _per_chunk(name, chunk)
    assert kept[1] - kept[0] == step and kept[2] - kept[1] == step, \
        (kept, step)
    # the plain loop keeps each step's intermediates too
    plain = [_kept(name, n, chunk, monkeypatch, remat=False) for n in (2, 3)]
    assert plain[1] - plain[0] > 2 * step, (plain, step)


def _parent_mlstm_chunkwise(q, k, v, i_gate, f_gate, chunk=256):
    """The parent's ``mlstm_chunkwise`` loop, from a fresh state."""
    B_, S, H_, hd = q.shape
    C_in, n_in, m_in = L.mlstm_init(B_, H_, hd)
    chunk = min(chunk, S)
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def padt(x, value=0.0):
        return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad), value=value)

    qf, vf = padt(q.float()), padt(v.float())
    kf = padt(k.float()) * hd ** -0.5
    ig = padt(i_gate.float(), L.NEG_INF)
    fg = padt(f_gate.float(), 80.0)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    hs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qi, ki, vi, ii, fi = qf[:, sl], kf[:, sl], vf[:, sl], ig[:, sl], \
            fg[:, sl]
        lf = -F.softplus(-fi)
        Fc = torch.cumsum(lf, dim=1)
        g = ii - Fc
        Mt = torch.maximum(m_in[:, None], torch.cummax(g, dim=1).values)
        m_t = Fc + Mt
        in_scale = torch.exp(m_in[:, None] - Mt)
        qk = torch.einsum("bthd,bshd->bhts", qi, ki)
        wts = torch.exp(torch.where(
            causal, g.transpose(1, 2)[:, :, None, :]
            - Mt.transpose(1, 2)[:, :, :, None], L.NEG_INF))
        A = torch.where(causal, qk * wts, 0.0)
        Cq = torch.einsum("bhij,bthj->bthi", C_in, qi)
        num = in_scale[..., None] * Cq + torch.einsum("bhts,bshd->bthd",
                                                      A, vi)
        nq = torch.einsum("bhj,bthj->bth", n_in, qi)
        den = in_scale * nq + A.sum(dim=-1).transpose(1, 2)
        floor = torch.exp(torch.clamp(-m_t, max=30.0))
        hs.append(num / torch.maximum(torch.abs(den), floor)[..., None])
        MT = Mt[:, -1]
        state_scale = torch.exp(m_in - MT)
        wk = torch.exp(g - MT[:, None])
        C_in = state_scale[..., None, None] * C_in + torch.einsum(
            "bshd,bsh,bshe->bhde", vi, wk, ki)
        n_in = state_scale[..., None] * n_in + torch.einsum(
            "bsh,bshd->bhd", wk, ki)
        m_in = Fc[:, -1] + MT
    return torch.cat(hs, dim=1)[:, :S].to(q.dtype), (C_in, n_in, m_in)


def _parent_slstm_scan(zifo, r_w):
    """The parent's ``slstm_scan`` loop, from a fresh state."""
    B_, S, H_, hd4 = zifo.shape
    c, n, h, m = L.slstm_init(B_, H_, hd4 // 4)
    xs, rw = zifo.float(), r_w.float()
    hs = []
    for t in range(S):
        rec = torch.einsum("bhi,hio->bho", h, rw)
        c, n, h, m = L.slstm_cell(*(xs[:, t] + rec).chunk(4, dim=-1), c, n,
                                  m)
        hs.append(h)
    return torch.stack(hs, dim=1).to(zifo.dtype), (c, n, h, m)


def _parent_mamba_scan(x, delta, A, Bm, Cm, D):
    """The parent's ``mamba_scan`` without autograd, from a fresh state."""
    Bb, S, H_, hd = x.shape
    h = torch.zeros((Bb, H_, hd, A.shape[-1]))
    xs, ds = x.float(), delta.float()
    Bs, Cs = Bm.float(), Cm.float()
    decay = torch.exp(ds.transpose(0, 1)[..., None, None] * A.float())
    inp = (ds[..., None] * xs).transpose(0, 1)[..., None] \
        * Bs.transpose(0, 1)[:, :, None, None, :]
    hs = torch.empty_like(decay)
    for t in range(S):
        h = torch.mul(decay[t], h, out=hs[t])
        h += inp[t]
    y = torch.einsum("sbhdn,bsn->bshd", hs, Cs) + D.float() * xs
    return y.to(x.dtype), (h.clone(),)


PARENT = {"mlstm_chunkwise": _parent_mlstm_chunkwise,
          "slstm_scan": _parent_slstm_scan,
          "mamba_scan": _parent_mamba_scan}


@pytest.mark.parametrize("S", [S_RAGGED, 300])
@pytest.mark.parametrize("name", SCANS)
def test_no_grad_path_keeps_the_parents_bits(name, S):
    ins, _ = _inputs(name, S, seed=4)
    tins = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    with torch.no_grad():
        got, got_st = _port(name, tins, None, 256)
        want, want_st = PARENT[name](*tins)
    assert torch.equal(got, want)
    for a, b in zip(got_st, want_st):
        assert torch.equal(a, b)


def _scan_grad_fn(name, chunk):
    def run(*args):
        out, states = _port(name, list(args), None, chunk)
        return torch.autograd.grad(out.float().sum(), args)
    return run


@pytest.mark.parametrize("name", ("slstm_scan", "mamba_scan"))
def test_fake_stand_ins_count_the_recompute(name):
    """On fake tensors the stand-ins run chunk by chunk under the
    checkpoint: a chunked backward's FLOPs are the unchunked one's plus a
    forward's, as on real tensors, and its peak of live bytes is lower."""
    S = 4 * CHUNK
    ins, _ = _inputs(name, S, seed=5)

    def tally(chunk, fake):
        if not fake:
            args = [torch.from_numpy(a).requires_grad_(True) for a in ins]
            return op_analysis.analyze(_scan_grad_fn(name, chunk),
                                       *args)[1].cards[torch.device("cpu")]
        with FakeTensorMode():
            args = [torch.empty(a.shape, device="meta:0", requires_grad=True)
                    for a in ins]
            return op_analysis.analyze(_scan_grad_fn(name, chunk),
                                       *args)[1].cards[torch.device("meta:0")]

    def forward_flops(fake):
        def fwd(*args):
            return _port(name, list(args), None, S)[0]
        if not fake:
            args = [torch.from_numpy(a) for a in ins]
            return op_analysis.analyze(fwd, *args)[1].cards[
                torch.device("cpu")].flops
        with FakeTensorMode():
            args = [torch.empty(a.shape, device="meta:0") for a in ins]
            return op_analysis.analyze(fwd, *args)[1].cards[
                torch.device("meta:0")].flops

    for fake in (False, True):
        chunked, whole = tally(CHUNK, fake), tally(S, fake)
        assert chunked.flops == whole.flops + forward_flops(fake), fake
        assert chunked.peak_bytes < whole.peak_bytes, fake
    assert tally(CHUNK, True).flops == tally(CHUNK, False).flops
