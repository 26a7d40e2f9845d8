"""The port's serving slice end to end, against the JAX package's.

The JAX ``gpt_teacher(params=P)`` and the port's
``gpt_teacher(params=P, device="cpu")`` serve the same requests —
including concurrent 1- and 2-row requests that adaptive batching
coalesces — and must agree on ``logits``/``probs`` and on the batch and
row counts of ``stats()``. Each server is driven by the OTHER package's
``RpcClient``, which shows the wire (frames, envelopes, ndarray tensor
frames) is unchanged between the two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edl_tpu.distill import teacher_server as jts
from edl_tpu.models import gpt as jgpt
from edl_tpu.rpc.client import RpcClient as JaxRpcClient
from edl_tpu.serve.admission import AdmissionController as JaxAdmission
from edl_tpu_torch.distill import teacher_server as tts
from edl_tpu_torch.rpc.client import RpcClient as TorchRpcClient
from edl_tpu_torch.serve.admission import \
    AdmissionController as TorchAdmission
from edl_tpu_torch.utils import errors

SEQ, VOCAB, MAX_BATCH = 16, 64, 3
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
