"""The port's continuous-batching ``DecodeEngine`` against the JAX
package: on the JAX decode suite's tiny f32 model (one flax tree for
both), every prompt decodes to exactly the tokens of the JAX package's
``models.gpt.generate`` — monolithic, prefix-reuse and chunked — under
one step shape (``decode_step_traces == 1``). Prefix-reuse accounting
and the ``stats()`` keys equal the JAX engine's; a faulted step fails
only its sequences; drain strands nothing; a deadline burned in the
queue is a typed eviction; the device loop runs whichever thread built
the engine; out-of-vocab ids are refused; the scaler reads
``decode_slot_frac``. Tokens are compared exactly."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import gpt as jgpt
from edl_tpu.serve import scaler as jscaler
from edl_tpu.serve.decode_engine import DecodeEngine as JaxEngine
from edl_tpu_torch.models import gpt as tgpt
from edl_tpu_torch.robustness.faults import FaultPlane
from edl_tpu_torch.serve.decode_engine import DecodeEngine
from edl_tpu_torch.serve.scaler import ServeScaler, load_actions
from edl_tpu_torch.utils import errors

SIZE = dict(num_layers=2, d_model=32, num_heads=2, mlp_dim=64,
            vocab_size=64, max_len=64)
NEW = 6
SHARED = [3, 1, 4, 1, 5, 9, 2, 6]
LONG = [(i * 7 + 3) % 64 or 1 for i in range(40)]
PROMPTS = ([1, 5, 9], [3, 3, 3], [9, 8, 7], [2, 4, 6], [1, 2, 1],
           [2, 3, 1], [3, 4, 1], [4, 5, 1], [5, 6, 1], [6, 7, 1],
           [2, 4, 6, 8], [7, 1, 7, 1], [1, 5, 9, 2, 4], [3, 3, 3, 1, 2],
           [9, 8, 7, 6, 5], SHARED + [7, 7], SHARED + [8, 8],
           SHARED + [9, 9], LONG)


@pytest.fixture(scope="module")
def tiny():
    jmodel = jgpt.gpt_tiny(dtype=jnp.float32, **SIZE)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = tgpt.Gpt(dtype=torch.float32, device="cpu", **SIZE)
    tmodel.load_state_dict(tgpt.params_from_flax(params))
    state = {k: v.detach() for k, v in tmodel.state_dict().items()}
    tmodel.to("meta")  # as lm_teacher keeps it: the state holds weights
    return jmodel, params, tmodel, state


@pytest.fixture(scope="module")
def refs(tiny):
    """The JAX package's ``generate`` tokens for every prompt of this
    file, ONE call per prompt length (as tests/test_decode_engine.py)."""
    jmodel, params, _, _ = tiny
    # jitted whole: one compile per length instead of one per primitive
    generate = jax.jit(lambda p, ids: jgpt.generate(jmodel, p, ids, NEW))
    out, by_len = {}, {}
    for p in PROMPTS:
        by_len.setdefault(len(p), []).append(p)
    for group in by_len.values():
        toks = np.asarray(generate(params, np.asarray(group, np.int32)))
        for p, row in zip(group, toks):
            out[tuple(p)] = [int(t) for t in row]
    return out


def _engine(tiny, **kw):
    _, _, tmodel, state = tiny
    kw.setdefault("admission", False)
    kw.setdefault("prefix_cache", False)
    return DecodeEngine(tmodel, state, **kw).start()


def test_engine_token_identical_to_jax_generate_one_step_trace(tiny, refs):
    eng = _engine(tiny, slots=4)
    try:
        prompts = [[1, 5, 9], [2, 4, 6, 8], [3, 3, 3], [7, 1, 7, 1],
                   [9, 8, 7]]
        handles = [eng.submit(p, NEW) for p in prompts]
        for p, h in zip(prompts, handles):
            rep = h.result(timeout=60.0)
            assert rep["tokens"] == refs[tuple(p)]
            assert len(rep["generated"]) == NEW
            assert type(rep["ttft_ms"]) is float
            assert all(type(t) is int for t in rep["tokens"])
        s = eng.stats()
        assert s["decode_step_traces"] == 1
        assert s["decode_prefill_traces"] == 1  # one bucket (4)
        assert s["decode_sequences_total"] == len(prompts)
        assert s["decode_kv_bytes"] == 2 * 2 * 4 * 64 * 32 * 4
    finally:
        eng.stop()


def _prefix_run(engine):
    """The JAX suite's prefix scenario: three prompts sharing 8 tokens,
    then the first again; returns (reports, stats)."""
    prompts = [SHARED + [7, 7], SHARED + [8, 8], SHARED + [9, 9],
               SHARED + [7, 7]]
    reports = [engine.generate(p, NEW, timeout=120.0) for p in prompts]
    return prompts, reports, engine.stats()


@pytest.fixture(scope="module")
def jax_prefix_stats(tiny):
    jmodel, params, _, _ = tiny
    eng = JaxEngine(jmodel, params, slots=4, admission=False,
                    prefix_cache=True)
    eng.start()
    try:
        return _prefix_run(eng)
    finally:
        eng.stop()


def test_prefix_reuse_accounting_equals_jax(tiny, refs, jax_prefix_stats):
    eng = _engine(tiny, slots=4, prefix_cache=True)
    try:
        prompts, reports, stats = _prefix_run(eng)
    finally:
        eng.stop()
    _, want_reports, want = jax_prefix_stats
    for p, r, w in zip(prompts, reports, want_reports):
        assert r["tokens"] == w["tokens"] == refs[tuple(p)]
    pfx, wpfx = stats["decode_prefix"], want["decode_prefix"]
    for key in ("hits", "misses", "evictions", "reuse_tokens",
                "stored_paths", "hit_rate", "cached_rows", "reuse_frac"):
        assert pfx[key] == wpfx[key], key
    assert pfx["hits"] == 3
    assert pfx["reuse_tokens"] == 2 * len(SHARED) + len(prompts[0]) - 1
    for key in ("decode_prefilled_tokens", "decode_tokens_total",
                "decode_sequences_total", "decode_step_traces",
                "decode_prefill_traces", "decode_chunk_traces"):
        assert stats[key] == want[key], key


def test_stats_keys_equal_jax_engine(tiny, jax_prefix_stats):
    eng = _engine(tiny, slots=2, prefix_cache=True)
    try:
        eng.generate([1, 2, 3], 2, timeout=60.0)
        got = eng.stats()
    finally:
        eng.stop()
    want = jax_prefix_stats[2]
    assert set(got) == set(want)
    assert set(got["decode_prefix"]) == set(want["decode_prefix"])
    assert set(got["decode_admission"]) == set(want["decode_admission"])
    assert got["decode_slot_frac"] == 0.0


@pytest.mark.parametrize("chunk", [3, 4])
def test_chunked_prefill_token_parity_one_step_trace(tiny, refs, chunk):
    eng = _engine(tiny, slots=4, prefill_chunk=chunk)
    try:
        prompts = [[1, 5, 9, 2, 4], [3, 3, 3, 1, 2], [9, 8, 7, 6, 5], LONG]
        handles = [eng.submit(p, NEW) for p in prompts]
        for p, h in zip(prompts, handles):
            assert h.result(timeout=120.0)["tokens"] == refs[tuple(p)]
        s = eng.stats()
        assert s["decode_step_traces"] == 1
        assert s["decode_prefill_traces"] == 0
        assert s["decode_chunk_traces"] <= 2  # solo + fused
        assert s["decode_prefilled_tokens"] == sum(len(p) for p in prompts)
        assert eng.drain(deadline_s=30.0)
    finally:
        eng.stop()


def test_faulted_step_fails_only_active_sequences(tiny, refs):
    eng = _engine(tiny, slots=1)
    plane = FaultPlane(seed=3)
    plane.inject("serve.decode.step", "error_once", after=3)
    plane.install()
    try:
        active = eng.submit([1, 2, 3], 20)        # takes the only slot
        waiter = eng.submit([2, 4, 6], NEW)       # queued behind it
        with pytest.raises(errors.DecodeStepError):
            active.result(timeout=60.0)
        assert waiter.result(timeout=60.0)["tokens"] == refs[(2, 4, 6)]
        s = eng.stats()
        assert s["decode_evicted_total"] == 1
        assert s["decode_slots_occupied"] == 0
        assert plane.log == [("serve.decode.step", "error_once")]
    finally:
        plane.uninstall()
        eng.stop()


def test_prefix_lookup_fault_is_lossless_cold_fallback(tiny, refs):
    eng = _engine(tiny, slots=4, prefix_cache=True)
    plane = FaultPlane(seed=5)
    plane.inject("serve.decode.prefix_lookup", "error")
    plane.install()
    try:
        for p in (SHARED + [7, 7], SHARED + [8, 8]):
            assert eng.generate(p, NEW, timeout=60.0)["tokens"] == \
                refs[tuple(p)]
        pfx = eng.stats()["decode_prefix"]
        assert pfx["hits"] == 0 and pfx["misses"] == 2
        assert eng.stats()["decode_evicted_total"] == 0
    finally:
        plane.uninstall()
        eng.stop()


@pytest.mark.parametrize("chunk", [0, 2])
def test_drain_strands_nothing(tiny, refs, chunk):
    """Drain finishes every admitted sequence — waiting ones, and under
    chunking one still mid-prefill — then the front door sheds."""
    eng = _engine(tiny, slots=2, prefill_chunk=chunk)
    try:
        prompts = [[i + 1, i + 2, 1] for i in range(6)] + [LONG]
        handles = [eng.submit(p, NEW) for p in prompts]
        assert eng.drain(deadline_s=60.0) is True
        for p, h in zip(prompts, handles):
            assert h.result(timeout=1.0)["tokens"] == refs[tuple(p)]
        s = eng.stats()
        assert s["decode_waiting"] == 0 and s["decode_active"] == 0
        assert s["decode_prefilling"] == 0 and s["decode_evicted_total"] == 0
        with pytest.raises(errors.OverloadedError, match="draining"):
            eng.submit([1, 2], 2)
    finally:
        eng.stop()


def test_deadline_burned_in_queue_is_a_typed_eviction(tiny):
    eng = _engine(tiny, slots=2)
    try:
        dead = eng.submit([1, 2, 3], 2, deadline_ms=0.0)
        with pytest.raises(errors.OverloadedError, match="deadline"):
            dead.result(timeout=30.0)
        assert eng.stats()["decode_evicted_total"] == 1
    finally:
        eng.stop()


def test_engine_runs_in_a_thread_other_than_the_one_that_built_it(
        tiny, refs):
    """Grad mode is thread-local: an engine built under
    ``torch.inference_mode()`` in one thread, started from another and
    fed from a third, updates its cache in place in its own loop
    thread."""
    _, _, tmodel, state = tiny
    built = {}

    def build():
        with torch.inference_mode():
            built["eng"] = DecodeEngine(tmodel, state, slots=2,
                                        admission=False, prefix_cache=True)

    t = threading.Thread(target=build)
    t.start()
    t.join()
    eng = built["eng"]
    assert not any(x.is_inference() for x in eng.kv.cache.values())
    starter = threading.Thread(target=eng.start)
    starter.start()
    starter.join()
    try:
        for p in ([1, 5, 9], SHARED + [7, 7], SHARED + [8, 8]):
            assert eng.generate(p, NEW, timeout=60.0)["tokens"] == \
                refs[tuple(p)]
        assert eng.stats()["decode_prefix"]["hits"] == 1
    finally:
        eng.stop()


@pytest.mark.parametrize("prompt", [[1, 64, 2], [-1], [3, 5, 1000]])
def test_out_of_vocab_ids_are_refused(tiny, prompt):
    eng = _engine(tiny, slots=1)
    try:
        with pytest.raises(errors.FeedSpecError, match="outside"):
            eng.submit(prompt, 2)
        assert eng.stats()["decode_sequences_total"] == 0
    finally:
        eng.stop()


class _Coord(object):
    def __init__(self):
        self.kv = {}

    def get_value(self, service, key):
        return self.kv.get((service, key))

    def set_server_permanent(self, service, key, value):
        self.kv[(service, key)] = value


def test_scaler_reads_decode_slot_frac(tiny):
    """A fleet idle on the predict plane whose KV slots are pinned
    scales OUT; the same fleet with free slots does nothing. The hot
    stats are a live engine's, with every slot held."""
    eng = _engine(tiny, slots=2)
    try:
        handles = [eng.submit([1, 2, 3], 40) for _ in range(2)]
        for _ in range(2000):
            hot = eng.stats()
            if hot["decode_slot_frac"] == 1.0:
                break
            threading.Event().wait(0.005)
        assert hot["decode_slot_frac"] == 1.0
        for h in handles:
            h.result(timeout=60.0)
    finally:
        eng.stop()
    coord, calls = _Coord(), []
    sc = ServeScaler(
        coord, "pod-decode", mode="on", interval=1.0,
        scale_out_fn=lambda: (calls.append("out"), "ep-new")[1],
        scale_in_fn=lambda ep: True, occupancy_high=0.8,
        out_streak=2, in_streak=1 << 20)
    hot = dict(hot, occupancy=0.0)
    acts = [a for t in range(3) for a in sc.tick({"t0": hot}, now=float(t))]
    assert [a["kind"] for a in acts] == ["scale_out"]
    assert calls == ["out"]
    assert [a["kind"] for a in load_actions(coord)] == ["scale_out"]
    cold = dict(hot, decode_slot_frac=0.25)
    sc2 = ServeScaler(
        coord, "pod-decode-2", mode="on", interval=1.0,
        scale_out_fn=lambda: "ep", scale_in_fn=lambda ep: True,
        occupancy_high=0.8, out_streak=2, in_streak=1 << 20)
    assert [a for t in range(4)
            for a in sc2.tick({"t0": cold}, now=float(t))] == []


def _fleet_trace(seed, ticks=60):
    """Seeded per-tick stats of a 3-teacher fleet and cumulative predict
    (total, bad) samples, in 10-tick phases: KV slots pinned, idle,
    predict latency burning, admission sheds, idle, slots pinned."""
    rng = np.random.RandomState(seed)
    total = bad = sheds = 0
    trace = []
    for t in range(ticks):
        phase = ("slots", "idle", "burn", "shed", "idle", "slots")[t // 10]
        total += 100
        bad += int(rng.randint(20, 60) if phase == "burn"
                   else rng.randint(0, 2))
        sheds += int(rng.randint(1, 3)) if phase == "shed" else 0
        stats = {"ep%d" % i: {
            "occupancy": float(rng.uniform(0.0, 0.2)),
            "decode_slot_frac": float(1.0 if phase == "slots"
                                      else rng.uniform(0.0, 0.4)),
            "queue_frac": float(rng.uniform(0.0, 0.2)),
            "shed_total": sheds,
            "decode_admission": {"shed_total": 0}} for i in range(3)}
        trace.append((stats, (total, bad)))
    return trace


@pytest.mark.parametrize("seed", [0, 1])
def test_scaler_decisions_equal_jax_scaler(seed):
    """The copied ``serve/scaler.py`` and ``obs/slo.py`` fold the same
    fleet trace into the same journaled decision stream as the JAX
    package's."""
    streams = []
    for mod in (jscaler, __import__("edl_tpu_torch.serve.scaler",
                                    fromlist=["x"])):
        sc = mod.ServeScaler(
            _Coord(), "pod", mode="on", interval=1.0,
            scale_out_fn=lambda: "ep-new", scale_in_fn=lambda ep: True,
            min_teachers=1, max_teachers=8, out_streak=2, in_streak=3,
            burst_window_s=10.0, clock=lambda: 0.0)
        acts = []
        for t, (stats, sample) in enumerate(_fleet_trace(seed)):
            acts += [(t, a["kind"], a.get("reason"), a.get("outcome"))
                     for a in sc.tick(stats, predict_sample=sample,
                                      now=float(t))]
        streams.append(acts)
    assert streams[0] == streams[1]
    # slot pressure (ticks 0-9) scales out on both
    assert streams[0] and streams[0][0][:2] == (1, "scale_out")
