"""The port's serving bench (``tools/serve_bench.py``), against the JAX
package's.

``run("micro")`` (schema ``serve_bench/v1``: open-loop overload, typed
sheds, scale-out and a drain-safe scale-in under seeded chaos, the dry
replay) is held to every assertion of the reference's gate
(tests/test_bench_guard.py's ``test_serve_bench_micro_schema``); its
process-wide ``EDL_TPU_RPC_WORKERS`` and fault plane must be restored
after it. ``run_decode`` builds models and engines and times them: its
whole run is the card's (chip_smoke.py). Here its pieces are held to the
reference's: ``_decode_prompts`` for the same knobs and seed,
``_signatures`` and ``_dry_replay`` on a fixed tick stream, and
``_decode_healthy`` on canned passing and failing reports.
"""

import copy
import json
import os

import pytest

from edl_tpu.tools import serve_bench as j_bench
from edl_tpu_torch.robustness import faults as t_faults
from edl_tpu_torch.tools import serve_bench as t_bench

from _torch_threads import _one_torch_thread  # noqa: F401


def test_serve_bench_micro_gates(monkeypatch):
    monkeypatch.setenv("EDL_TPU_RPC_WORKERS", "3")
    out = t_bench.run(mode="micro", seed=7)
    # the bench's process-wide knobs are put back
    assert os.environ["EDL_TPU_RPC_WORKERS"] == "3"
    assert t_faults.PLANE is None

    assert out["schema"] == "serve_bench/v1"
    assert out["sent"] > 0 and out["ok"] > 0
    assert out["goodput_rps"] > 0

    # overload produced typed sheds, and ONLY typed sheds
    assert out["shed"]["total"] > 0
    assert out["shed"]["rate"] > 0
    assert out["shed"]["with_retry_after_hint"] > 0
    assert sum(out["shed"]["by_reason"].values()) == out["shed"]["total"]
    assert out["timeouts"] == 0
    assert out["untyped_errors"] == 0

    # zero stranded requests, by count AND by drain report
    assert out["stranded"] == 0
    assert out["drain"]["zero_stranded"] is True
    assert all(r["drained"] and r["pending_rows"] == 0
               for r in out["drain"]["reports"])

    # the forced cycle scaled out and back in; the drain drill fired
    assert out["scaler"]["scale_out"] >= 1
    assert out["scaler"]["scale_in"] >= 1
    assert out["faults_fired"].get("serve.drain", 0) >= 1

    # dry mode journals the IDENTICAL action stream to on mode
    assert out["dry_parity_ok"] is True
    assert out["live_action_stream"] == out["dry_action_stream"]

    # stats RPCs stayed answerable under overload (strict priority)
    assert out["stats_rpc_ms"]["p99"] is not None
    assert out["stats_rpc_ms"]["p99"] < out["latency_ms"]["p99"]

    # the clean control fleet stays silent
    assert out["clean"]["shed_total"] == 0
    assert out["clean"]["scaler_actions"] == 0
    assert out["clean"]["stranded"] == 0
    json.dumps(out)


def test_serve_bench_env_restored_when_unset(monkeypatch):
    monkeypatch.delenv("EDL_TPU_RPC_WORKERS", raising=False)
    monkeypatch.setattr(t_bench, "_run",
                        lambda knobs, mode, seed: os.environ[
                            "EDL_TPU_RPC_WORKERS"])
    assert t_bench.run("micro") == str(t_bench.BENCH_RPC_WORKERS)
    assert "EDL_TPU_RPC_WORKERS" not in os.environ


def test_knob_tables_match():
    assert t_bench.MODES == j_bench.MODES
    assert t_bench.DECODE_MODES == j_bench.DECODE_MODES
    assert t_bench.PREFIX_MODES == j_bench.PREFIX_MODES
    assert t_bench.BENCH_RPC_WORKERS == j_bench.BENCH_RPC_WORKERS


@pytest.mark.parametrize("mode", ["micro", "full"])
@pytest.mark.parametrize("seed", [7, 11])
def test_decode_prompts_match(mode, seed):
    knobs = t_bench.DECODE_MODES[mode]
    assert t_bench._decode_prompts(knobs, seed) == \
        j_bench._decode_prompts(knobs, seed)


def _ticks(interval):
    """A tick stream that must make a scaler scale out, then in: one
    teacher saturated, then two nearly idle."""
    out, now = [], 1000.0
    for _ in range(4):
        now += interval
        out.append((now, {"a:1": {"occupancy": 0.95, "max_batch": 4}}))
    for _ in range(10):
        now += interval
        out.append((now, {"a:1": {"occupancy": 0.1, "max_batch": 4},
                          "b:2": {"occupancy": 0.05, "max_batch": 4}}))
    return out


def test_dry_replay_and_signatures_match():
    knobs = t_bench.MODES["micro"]
    cycle = {"snapshots": _ticks(knobs["interval"])}
    got = t_bench._dry_replay(knobs, copy.deepcopy(cycle))
    want = j_bench._dry_replay(knobs, copy.deepcopy(cycle))
    assert got == want
    kinds = [sig[1] for sig in got]
    assert "scale_out" in kinds and "scale_in" in kinds
    actions = [{"seq": 1, "kind": "scale_out", "target": "x",
                "decision": {"occupancy": 0.9}, "mode": "on",
                "outcome": "applied", "attempts": 1},
               {"seq": 2, "kind": "scale_in", "target": "y",
                "mode": "dry", "outcome": "dry"}]
    assert t_bench._signatures(actions) == j_bench._signatures(actions)


def _healthy_report():
    return {
        "parity": {"serial_vs_generate_ok": True,
                   "cb_vs_generate_ok": True},
        "throughput": {"speedup": 2.0},
        "compile": {"step_traces": 1},
        "shed": {"reasons_covered": sorted(
            t_bench.DECODE_SHED_REASONS), "stranded": 0},
        "scale_out": {"zero_stranded": True, "scale_out": 1},
        "prefix": {"parity_ok": True, "accounting_exact": True,
                   "ttft_speedup": 2.0},
        "chunked": {"chunked_within_2x": True,
                    "monolithic_exceeds_2x": True, "step_traces": 1,
                    "prefill_traces": 0},
    }


FAULTS = [("parity", "cb_vs_generate_ok", False),
          ("throughput", "speedup", 1.4),
          ("compile", "step_traces", 2),
          ("shed", "reasons_covered", ["slots"]),
          ("shed", "stranded", 1),
          ("scale_out", "scale_out", 0),
          ("prefix", "ttft_speedup", 1.49),
          ("prefix", "accounting_exact", False),
          ("chunked", "monolithic_exceeds_2x", False),
          ("chunked", "prefill_traces", 3)]


@pytest.mark.parametrize("fault", [None] + FAULTS,
                         ids=["healthy"] + ["%s.%s" % f[:2] for f in FAULTS])
def test_decode_healthy_matches(fault):
    assert t_bench.DECODE_SHED_REASONS == j_bench.DECODE_SHED_REASONS
    report = _healthy_report()
    if fault is not None:
        section, key, value = fault
        report[section][key] = value
    got = t_bench._decode_healthy(report)
    assert got == j_bench._decode_healthy(report)
    assert got is (fault is None)
