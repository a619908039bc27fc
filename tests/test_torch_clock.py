"""A shared constant clock for the tests that hold the port's runtime
against the JAX package's.

Both ``ContinuousRuntime``s advance their virtual clocks by measured wall
time: each retrieval stage by ``max(wall, stage.seconds)``, each prefill
and decode iteration by its wall time.  So the batches they form, and with
them which docs are already cached when a request begins, follow how fast
each framework happens to run on the machine at that moment: two correct
runtimes can disagree on a loaded host.  ``shared_clock`` replaces the
``time`` module of both runtime modules with one whose ``perf_counter``
returns a constant (every other attribute is the real module's), so every
measured wall time is 0: the analytic stage costs drive retrieval, the
engine's iterations take no virtual time, and both schedules depend only
on the workload.

The test files that compare the two runtimes' tokens, flags or counters
hold the clock for their whole module (``constant_clock``, a module-scoped
autouse fixture imported there).  The tests below show the repair: with
the port's clock stepping 0.5 s a call and JAX's standing still, the
chunk-reuse comparison fails; under ``shared_clock`` it passes.
"""
import contextlib
import time
import types

import pytest

import repro.serving.runtime as jax_runtime
import repro_torch.serving.runtime as torch_runtime

RUNTIMES = (jax_runtime, torch_runtime)


def _clock(perf_counter):
    """The real ``time`` module's attributes, but ``perf_counter``."""
    ns = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                  if not k.startswith("__")})
    ns.perf_counter = perf_counter
    return ns


@contextlib.contextmanager
def shared_clock(mp=None):
    """Both runtime modules read one constant ``perf_counter`` while the
    context is open (through ``mp``, a ``pytest.MonkeyPatch``, when one is
    given, else a fresh one undone on exit)."""
    with contextlib.ExitStack() as stack:
        if mp is None:
            mp = stack.enter_context(pytest.MonkeyPatch.context())
        clock = _clock(lambda: 0.0)
        for mod in RUNTIMES:
            mp.setattr(mod, "time", clock)
        yield


@pytest.fixture(scope="module", autouse=True)
def constant_clock():
    """Holds ``shared_clock`` for the module that imports this fixture."""
    with shared_clock():
        yield


def _stepping(step):
    t = [0.0]

    def perf_counter():
        t[0] += step
        return t[0]
    return perf_counter


def _skew(mp):
    """The port's runtime sees its wall clock step 0.5 s a call; JAX's
    stands still: the port looks far slower than the JAX package."""
    mp.setattr(torch_runtime, "time", _clock(_stepping(0.5)))
    mp.setattr(jax_runtime, "time", _clock(lambda: 0.0))


@pytest.fixture(scope="module")
def chunk_setup():
    from test_torch_chunk_reuse import make_setup
    return make_setup()


@pytest.mark.parametrize("chunk", [0, 5])
def test_skewed_clocks_change_the_schedule(chunk_setup, chunk):
    """Control: without the shared clock the skew alone makes the
    cross-framework chunk-reuse comparison fail."""
    from test_torch_chunk_reuse import compare_with_jax
    with pytest.MonkeyPatch.context() as mp:
        _skew(mp)
        with pytest.raises(AssertionError):
            compare_with_jax(chunk_setup, chunk)


@pytest.mark.parametrize("chunk", [0, 5])
def test_shared_clock_repairs_the_skewed_comparison(chunk_setup, chunk):
    """The same skew, then the shared clock: the comparison passes."""
    from test_torch_chunk_reuse import compare_with_jax
    with pytest.MonkeyPatch.context() as mp:
        _skew(mp)
        with shared_clock(mp):
            compare_with_jax(chunk_setup, chunk)
