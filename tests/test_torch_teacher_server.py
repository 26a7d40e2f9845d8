"""The port's serving slice end to end, against the JAX package's.

The JAX ``gpt_teacher(params=P)`` and the port's
``gpt_teacher(params=P, device="cpu")`` serve the same requests —
including concurrent 1- and 2-row requests that adaptive batching
coalesces — and must agree on ``logits``/``probs`` and on the batch and
row counts of ``stats()``. Likewise the two ``lm_teacher``s (the decode
plane, f32): the same ``lm_generate`` tokens, ``lm_poll`` streams,
``get_feed_fetch`` capacities, ``stats()`` keys and drain. Each server
is driven by the OTHER package's ``RpcClient``, which shows the wire
(frames, envelopes, ndarray tensor frames) is unchanged between the
two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.distill import teacher_server as jts
from edl_tpu.models import gpt as jgpt
from edl_tpu.rpc.client import RpcClient as JaxRpcClient
from edl_tpu.serve.admission import AdmissionController as JaxAdmission
from edl_tpu_torch.distill import teacher_server as tts
from edl_tpu_torch.rpc.client import RpcClient as TorchRpcClient
from edl_tpu_torch.serve.admission import \
    AdmissionController as TorchAdmission
from edl_tpu_torch.utils import errors

from _torch_threads import _one_torch_thread  # noqa: F401


SEQ, VOCAB, MAX_BATCH = 16, 64, 3
# the decode plane's tiny f32 model: the JAX decode suite's
# (tests/test_decode_engine.py)
LM = dict(num_layers=2, d_model=32, num_heads=2, mlp_dim=64,
          vocab_size=VOCAB, max_len=64, slots=4)
LM_NEW = 6
# f32 on both sides: only the summation order differs
F32_TOL = 1e-4
SIZE = dict(num_layers=2, d_model=32, num_heads=2, mlp_dim=64,
            vocab_size=VOCAB, seq_len=SEQ)
# both servers run bf16 activations (as gpt_teacher builds the model);
# see tests/test_torch_gpt.py: two bf16 ulps at |logits| < 8
BF16_TOL = 2 * 2.0 ** -5


@pytest.fixture(scope="module")
def flax_params():
    model = jgpt.Gpt(num_layers=2, d_model=32, num_heads=2, mlp_dim=64,
                     vocab_size=VOCAB, max_len=SEQ, dtype=jnp.bfloat16)
    return model.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, SEQ), jnp.int32))["params"]


@pytest.fixture()
def servers(flax_params, monkeypatch):
    monkeypatch.setenv("EDL_TPU_DISABLE_UDS", "1")
    # a long coalescing wait makes the batching deterministic: a batch
    # flushes exactly when its rows reach max_batch; admission stays on
    # without its queue-wait SLO, which a loaded test host could miss
    kw = dict(SIZE, max_batch=MAX_BATCH, host="127.0.0.1",
              batch_timeout_ms=5000.0)
    jax_srv = jts.gpt_teacher(params=flax_params, **kw,
                              admission=JaxAdmission(slo_ms=None)).start()
    torch_srv = tts.gpt_teacher(params=flax_params, device="cpu", **kw,
                                admission=TorchAdmission(slo_ms=None)
                                ).start()
    clients = [TorchRpcClient(jax_srv.endpoint),
               JaxRpcClient(torch_srv.endpoint)]
    try:
        yield clients
    finally:
        for c in clients:
            c.close()
        jax_srv.stop()
        torch_srv.stop()


def _feed(rows, seed):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(0, VOCAB, (rows, SEQ)).astype(
        np.int32)}


def _serve(client):
    """Three device batches of 3 rows: 1+2 concurrent, 1+1+1
    concurrent, one 3-row request."""
    waves = [[(1, 0), (2, 1)], [(1, 2), (1, 3), (1, 4)], [(3, 5)]]
    outs = []
    for wave in waves:
        futs = [client.call_async("predict", _feed(rows, seed))
                for rows, seed in wave]
        outs += [f.result(timeout=120) for f in futs]
    return outs, client.call("stats")


def test_port_teacher_matches_jax_teacher(servers):
    jax_side, torch_side = servers
    want, want_stats = _serve(jax_side)
    got, got_stats = _serve(torch_side)
    assert [len(o["logits"]) for o in got] == [1, 2, 1, 1, 1, 3]
    for g, w in zip(got, want):
        assert g["logits"].shape == w["logits"].shape
        assert g["logits"].dtype == np.float32 == g["probs"].dtype
        np.testing.assert_allclose(g["logits"], w["logits"], rtol=0,
                                   atol=BF16_TOL)
        # probs by their logarithm, which moves with the logits: an
        # absolute limit on probs themselves (typically 1/VOCAB) would
        # hold nothing
        np.testing.assert_allclose(np.log(g["probs"]), np.log(w["probs"]),
                                   rtol=0, atol=BF16_TOL)
        np.testing.assert_allclose(g["probs"].sum(-1), 1.0, atol=1e-5)
    for key in ("batches", "rows", "max_batch", "occupancy"):
        assert got_stats[key] == want_stats[key], key
    assert got_stats["batches"] == 3 and got_stats["rows"] == 9


def test_port_teacher_wire_surface(servers):
    jax_side, torch_side = servers
    got = torch_side.call("get_feed_fetch")
    want = jax_side.call("get_feed_fetch")
    assert got == want
    assert got["feed"] == {"input_ids": [[SEQ], "<i4"]}
    assert set(torch_side.call("__features__")) == set(
        jax_side.call("__features__"))
    # a typed error crosses the wire under its own class name
    with pytest.raises(Exception) as exc:
        torch_side.call("predict", _feed(MAX_BATCH + 1, 0))
    assert type(exc.value).__name__ == "FeedSpecError"


def test_port_teacher_rejects_out_of_vocab_ids():
    srv = tts.gpt_teacher(**SIZE, max_batch=2, device="cpu",
                          adaptive_batch=False)
    ids = np.full((1, SEQ), VOCAB, np.int32)
    with pytest.raises(errors.FeedSpecError, match="outside"):
        srv._predict_rpc({"input_ids": ids})


def test_nop_teacher_serves_zeros(monkeypatch):
    monkeypatch.setenv("EDL_TPU_DISABLE_UDS", "1")
    srv = tts.nop_teacher({"logits": ([4], "<f4")}, max_batch=2,
                          host="127.0.0.1").start()
    try:
        client = TorchRpcClient(srv.endpoint)
        out = client.call("predict", {"ins": np.ones((1, 1), np.float32)})
        client.close()
    finally:
        srv.stop()
    np.testing.assert_array_equal(out["logits"], np.zeros((1, 4)))


@pytest.fixture(scope="module")
def lm_servers():
    model = jgpt.gpt_tiny(**{k: v for k, v in LM.items() if k != "slots"},
                          dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EDL_TPU_DISABLE_UDS", "1")
        kw = dict(LM, max_batch=1, host="127.0.0.1")
        jax_srv = jts.lm_teacher(params=params, **kw).start()
        torch_srv = tts.lm_teacher(params=params, device="cpu", **kw).start()
    clients = [TorchRpcClient(jax_srv.endpoint, timeout=120.0),
               JaxRpcClient(torch_srv.endpoint, timeout=120.0)]
    try:
        yield clients
    finally:
        for c in clients:
            c.close()
        jax_srv.stop()
        torch_srv.stop()


_LM_PROMPTS = [[1, 5, 9], [2, 4, 6, 8], [3, 3, 3], [7, 1, 7, 1, 5, 9, 2],
               [9, 8, 7]]


def _lm_stream(client, prompt):
    seq = client.call("lm_submit", prompt, LM_NEW)["seq"]
    tokens, done = [], False
    while not done:
        out = client.call("lm_poll", seq, len(tokens))
        tokens += out["tokens"]
        done = out["done"]
    return tokens


def test_lm_teacher_generate_and_poll_match_jax(lm_servers):
    jax_side, torch_side = lm_servers
    results = []
    for client in (jax_side, torch_side):
        futs = [client.call_async("lm_generate", p, LM_NEW)
                for p in _LM_PROMPTS]
        reports = [f.result(timeout=120) for f in futs]
        streams = [_lm_stream(client, p) for p in _LM_PROMPTS[:2]]
        results.append((reports, streams))
    (want, want_streams), (got, got_streams) = results
    for p, g, w in zip(_LM_PROMPTS, got, want):
        assert g["tokens"] == w["tokens"]
        assert g["tokens"][:len(p)] == p
        assert g["generated"] == w["generated"] == g["tokens"][len(p):]
        assert all(type(t) is int for t in g["tokens"])
        assert type(g["ttft_ms"]) is float
    assert got_streams == want_streams
    assert got_streams[0] == got[0]["generated"]


def test_lm_teacher_predict_matches_jax(lm_servers):
    jax_side, torch_side = lm_servers
    feed = {"input_ids": np.random.RandomState(3).randint(
        0, VOCAB, (1, LM["max_len"])).astype(np.int32)}
    want = jax_side.call("predict", feed)
    got = torch_side.call("predict", feed)
    for key in ("logits", "probs"):
        assert got[key].shape == want[key].shape == (1, 64, VOCAB)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=F32_TOL,
                               atol=F32_TOL)
    with pytest.raises(Exception) as exc:
        torch_side.call("predict", {"input_ids": np.full(
            (1, LM["max_len"]), VOCAB, np.int32)})
    assert type(exc.value).__name__ == "FeedSpecError"


def test_lm_teacher_surface_stats_and_drain(lm_servers):
    jax_side, torch_side = lm_servers
    got = torch_side.call("get_feed_fetch")
    want = jax_side.call("get_feed_fetch")
    assert got == want
    assert "decode.engine" in got["features"]
    assert got["capacity_decode"] == float(LM["slots"])
    got_stats = torch_side.call("stats")
    want_stats = jax_side.call("stats")
    assert set(got_stats) == set(want_stats)
    assert got_stats["decode_step_traces"] == 1
    with pytest.raises(Exception) as exc:
        torch_side.call("lm_generate", [VOCAB + 1], 2)
    assert type(exc.value).__name__ == "FeedSpecError"
    for client in (jax_side, torch_side):
        report = client.call("drain", 30.0)
        assert report["drained"] is True
        with pytest.raises(Exception) as exc:
            client.call("lm_generate", [1, 2], 2)
        assert type(exc.value).__name__ == "OverloadedError"


def test_decommission_drains_port_lm_teacher(monkeypatch):
    """``serve/drain.py`` on the port's lm_teacher: sequences in flight
    when the drain starts all finish, then the server stops."""
    from edl_tpu_torch.serve.drain import decommission

    monkeypatch.setenv("EDL_TPU_DISABLE_UDS", "1")
    srv = tts.lm_teacher(**LM, max_batch=1, host="127.0.0.1",
                         device="cpu").start()
    engine = srv.decode_engine
    handles = [engine.submit([i + 1, 2, 3], LM_NEW) for i in range(6)]
    report = decommission(srv, deadline_s=60.0)
    assert report["drained"] is True and report["advertised"] is False
    for h in handles:
        assert len(h.result(timeout=1.0)["generated"]) == LM_NEW
    assert not engine.running
