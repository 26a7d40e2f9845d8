"""The student's read path on the port, against the JAX package's.

``ClientPool``, the timeline, ``DistillReader`` (with ``FixedDiscover``
and ``DiscoveryClient``) and ``_TeacherConn`` are host-only copies: the
same call scripts run on both packages and must give the same pool
stats step by step and byte-equal batches. Readers and teachers are
cross-wired both ways (the wire is shared), and the port's dynamic
teacher path runs against the JAX package's in-process store, teacher
register and discovery server. Every server binds a free port on
127.0.0.1 and is stopped in a ``finally``; timeouts and back-offs are a
second or less.
"""

import io
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

from edl_tpu.coordination.embedded import EmbeddedStore
from edl_tpu.distill import distill_reader as j_reader
from edl_tpu.distill import teacher_server as j_teacher
from edl_tpu.distill.discovery_server import DiscoveryServer
from edl_tpu.distill.registry import TeacherRegister
from edl_tpu.rpc import pool as j_pool
from edl_tpu.rpc import server as j_server
from edl_tpu.utils import errors as j_errors
from edl_tpu_torch.distill import discovery_client as t_discovery
from edl_tpu_torch.distill import distill_reader as t_reader
from edl_tpu_torch.distill import teacher_server as t_teacher
from edl_tpu_torch.obs import metrics as t_metrics
from edl_tpu_torch.rpc import pool as t_pool
from edl_tpu_torch.rpc import server as t_server
from edl_tpu_torch.utils import errors as t_errors
from edl_tpu_torch.utils import timeline as t_timeline

from _torch_threads import _one_torch_thread  # noqa: F401


PKGS = {
    "jax": SimpleNamespace(reader=j_reader, teacher=j_teacher, pool=j_pool,
                           server=j_server, errors=j_errors),
    "torch": SimpleNamespace(reader=t_reader, teacher=t_teacher,
                             pool=t_pool, server=t_server,
                             errors=t_errors),
}
# the reader's back-off after a teacher failure, and every RPC deadline
BACKOFF, TIMEOUT = 0.5, 5.0


def _wait(pred, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _echo_teacher(pkg, scale):
    def fn(feed):
        return {"soft_label": feed["img"] * scale}
    return pkg.teacher.TeacherServer(
        fn, {"img": ([2], "<f4")}, {"soft_label": ([2], "<f4")},
        max_batch=16, host="127.0.0.1").start()


def _reader(pkg, **kw):
    kw.setdefault("teacher_backoff", BACKOFF)
    kw.setdefault("predict_timeout", TIMEOUT)
    return pkg.reader.DistillReader(ins=["img"], predicts=["soft_label"],
                                    **kw)


def _bytes(tree):
    """A yielded batch as nested tuples of (dtype, shape, bytes)."""
    if isinstance(tree, (list, tuple)):
        return tuple(_bytes(x) for x in tree)
    a = np.asarray(tree)
    return (a.dtype.str, a.shape, a.tobytes())


# -- the pool ----------------------------------------------------------------

def _script_shares(pool, ep):
    yield pool.get(ep) is pool.get(ep)
    yield pool.call(ep, "echo", 7)


def _script_channels(pool, ep):
    yield pool.get(ep, channel="ctl") is not pool.get(ep, channel="assign")
    yield pool.call(ep, "echo", 1, channel="ctl")
    yield pool.call(ep, "echo", 2, channel="assign")


def _script_reap(pool, ep):
    yield pool.call(ep, "echo", 1)
    # idle past the ttl: the reaper closes and drops the client
    yield _wait(lambda: pool.stats()["open"] == 0)
    yield pool.call(ep, "echo", 2)


def _script_retire(pool, ep):
    yield pool.call(ep, "echo", 1, channel="ctl")
    yield pool.call(ep, "echo", 1, channel="hb")
    yield bool(pool.features(ep))
    pool.retire(ep)
    yield pool._features == {}
    yield pool.call(ep, "echo", 2)


SCRIPTS = {"shares_one_client": (_script_shares, {}),
           "channels": (_script_channels, {}),
           "idle_reap_and_redial": (_script_reap,
                                    dict(idle_ttl=0.3, reap_interval=0.05)),
           "retire_drops_all": (_script_retire, {})}


@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_pool_stats_match_step_by_step(script, server_pkg):
    """The reference's four call scripts (tests/test_rpc_pool.py) on both
    packages' pools against one package's server: after every step the
    results and ``stats()`` (open, dials, reaps, retires) are equal."""
    fn, kw = SCRIPTS[script]
    srv = PKGS[server_pkg].server.RpcServer(host="127.0.0.1")
    srv.register("echo", lambda x: x)
    srv.start()
    pools = [j_pool.ClientPool(**kw), t_pool.ClientPool(**kw)]
    try:
        steps = [fn(p, srv.endpoint) for p in pools]
        n = 0
        for j_out, t_out in zip(*steps):
            assert j_out == t_out, (script, n)
            j_stats, t_stats = (p.stats() for p in pools)
            assert sorted(t_stats) == ["dials", "open", "reaps", "retires"]
            assert t_stats == j_stats, (script, n)
            n += 1
        assert n >= 2
        gauge = t_metrics.REGISTRY.families()["edl_rpc_pool_open"]
        assert gauge.value == pools[1].stats()["open"]
    finally:
        for p in pools:
            p.close()
        srv.stop()


def test_pool_close_rejects_checkout():
    srv = t_server.RpcServer(host="127.0.0.1")
    srv.register("echo", lambda x: x)
    srv.start()
    pool = t_pool.ClientPool()
    try:
        assert pool.call(srv.endpoint, "echo", 1) == 1
        pool.close()
        pool.close()  # idempotent
        with pytest.raises(t_errors.StatusError, match="closed"):
            pool.get(srv.endpoint)
    finally:
        pool.close()
        srv.stop()


# -- the timeline ---------------------------------------------------------

def test_timeline_spans_land_in_the_histogram(monkeypatch):
    hist = t_metrics.REGISTRY.families()["edl_timeline_op_ms"]
    monkeypatch.delenv("EDL_TPU_PROFILE", raising=False)
    monkeypatch.delenv("DISTILL_READER_PROFILE", raising=False)
    t_timeline.reset()
    try:
        tl = t_timeline.get_timeline()
        assert isinstance(tl, t_timeline._NopTimeLine)
        count0 = hist.labels("probe-op")._count
        with tl.span("probe-op"):
            time.sleep(0.01)
        assert hist.labels("probe-op")._count == count0 + 1
        assert hist.labels("probe-op")._sum >= 10.0 * 0.9
        # read once: flipping the environment changes nothing ...
        monkeypatch.setenv("EDL_TPU_PROFILE", "1")
        assert t_timeline.get_timeline() is tl
        # ... until reset re-reads it
        t_timeline.reset()
        real = t_timeline.get_timeline()
        assert not isinstance(real, t_timeline._NopTimeLine)
        buf = io.StringIO()
        sink = t_timeline.get_timeline(out=buf)
        sink.record("probe-lap")
        assert "op=probe-lap" in buf.getvalue()
        # torch_trace is a no-op without a directory
        with t_timeline.torch_trace(None):
            pass
    finally:
        t_timeline.reset()


# -- the reader's cases, on both packages ---------------------------------

def _case_fixed_ordering(rd, te):
    teacher = _echo_teacher(te, 2.0)

    def gen():
        for i in range(20):
            yield (np.full((4, 2), i, np.float32),
                   np.full((4, 1), i, np.int64))

    dr = _reader(rd, max_in_flight=4)
    dr.set_batch_generator(gen)
    dr.set_fixed_teacher([teacher.endpoint])
    try:
        first = [_bytes(b) for b in dr()]
        assert [b[0][2][:4] for b in first] == [
            np.float32(i).tobytes() for i in range(20)]
        second = [_bytes(b) for b in dr()]  # a second epoch works
        return first + second
    finally:
        dr.stop()
        teacher.stop()


def _case_sample_list_teacher_failure(rd, te):
    t1, t2 = _echo_teacher(te, 3.0), _echo_teacher(te, 3.0)

    def gen():
        for i in range(30):
            yield [(np.full(2, i + j, np.float32),) for j in range(3)]

    dr = _reader(rd, max_in_flight=4)
    dr.set_sample_list_generator(gen)
    dr.set_fixed_teacher([t1.endpoint, t2.endpoint])
    out = []
    try:
        for i, samples in enumerate(dr()):
            out.append(_bytes(samples))
            if i == 5:
                t1.stop()  # mid-epoch: its tasks must be retried
        return out
    finally:
        dr.stop()
        t1.stop()
        t2.stop()


def _case_abandoned_epoch(rd, te):
    teacher = _echo_teacher(te, 1.0)

    def gen():
        for i in range(20):
            yield (np.full((2, 2), i, np.float32),)

    dr = _reader(rd, max_in_flight=4)
    dr.set_batch_generator(gen)
    dr.set_fixed_teacher([teacher.endpoint])
    try:
        for i, _ in enumerate(dr()):
            if i == 2:
                break  # abandon the epoch with tasks in flight
        time.sleep(0.3)
        return [_bytes(b) for b in dr()]
    finally:
        dr.stop()
        teacher.stop()


def _case_sample_generator(rd, te):
    teacher = _echo_teacher(te, 1.0)

    def gen():
        for i in range(10):
            yield (np.full(2, i, np.float32),)

    dr = _reader(rd)
    dr.set_sample_generator(gen, batch_size=4)
    dr.set_fixed_teacher([teacher.endpoint])
    try:
        return [_bytes(b) for b in dr()]
    finally:
        dr.stop()
        teacher.stop()


def _case_feeder_exception(rd, te):
    teacher = _echo_teacher(te, 2.0)

    def gen():
        for i in range(5):
            yield np.full((2, 2), i, np.float32),
        raise RuntimeError("source storage went away")

    dr = _reader(rd, max_in_flight=4)
    dr.set_batch_generator(gen)
    dr.set_fixed_teacher([teacher.endpoint])
    out = []
    try:
        with pytest.raises(RuntimeError, match="source storage"):
            for batch in dr():
                out.append(_bytes(batch))
        return out
    finally:
        dr.stop()
        teacher.stop()


def _case_pre_pipelining_teacher(rd, te):
    srv = te.server.RpcServer(host="127.0.0.1", port=0, workers=0)
    srv.register("get_feed_fetch",
                 lambda: {"feed": {"img": ([2], "<f4")},
                          "fetch": {"soft_label": ([2], "<f4")},
                          "max_batch": 16})  # no "features" key
    srv.register("predict",
                 lambda feed: {"soft_label":
                               np.asarray(feed["img"]) * 4.0})
    srv.start()

    def gen():
        for i in range(8):
            yield np.full((3, 2), i, np.float32),

    dr = _reader(rd, pipeline_depth=4)
    dr.set_batch_generator(gen)
    dr.set_fixed_teacher(["127.0.0.1:%d" % srv.port])
    try:
        return [_bytes(b) for b in dr()]
    finally:
        dr.stop()
        srv.stop()


CASES = {"fixed_ordering": (_case_fixed_ordering, 40),
         "sample_list_teacher_failure": (_case_sample_list_teacher_failure,
                                         30),
         "abandoned_epoch_fenced": (_case_abandoned_epoch, 20),
         "sample_generator_batching": (_case_sample_generator, 3),
         "feeder_exception_reraised": (_case_feeder_exception, 5),
         "pre_pipelining_teacher": (_case_pre_pipelining_teacher, 8)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_batches_byte_equal_across_packages(case):
    """The reference's DistillReader cases (tests/test_distill.py) on
    both packages, each reader against each package's ``TeacherServer``
    (so cross-wired both ways): the same batches, byte for byte, in the
    same order, each exactly once."""
    fn, n = CASES[case]
    combos = [("jax", "jax"), ("torch", "torch"), ("torch", "jax"),
              ("jax", "torch")]
    # the runs are independent (own teachers, own ports): run them side
    # by side, as each waits most of its time on its manage loop
    with ThreadPoolExecutor(len(combos)) as ex:
        futs = [ex.submit(fn, PKGS[rd], PKGS[te]) for rd, te in combos]
        outs = {combo: f.result() for combo, f in zip(combos, futs)}
    assert len(outs["torch", "torch"]) == n
    for combo in combos[1:]:
        assert outs[combo] == outs["jax", "jax"], combo


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_killed_teacher_fails_pending_futures_fast(pkg):
    """A teacher stopped (its connections severed, as a process death)
    with predicts in flight: every pending future of ``_TeacherConn``
    fails with ConnectError within seconds, none hangs."""
    mod = PKGS[pkg]
    gate = threading.Event()

    def fn(feed):
        gate.wait(0.5)
        return {"soft_label": feed["img"] * 1.0}

    teacher = mod.teacher.TeacherServer(
        fn, {"img": ([2], "<f4")}, {"soft_label": ([2], "<f4")},
        max_batch=2, host="127.0.0.1").start()
    conn = mod.reader._TeacherConn(teacher.endpoint, timeout=30.0)
    try:
        assert conn.pipelined
        futs = [conn.predict_async({"img": np.full((2, 2), i, np.float32)})
                for i in range(4)]
        time.sleep(0.2)  # on the wire, the first one in the device loop
        t0 = time.monotonic()
        teacher.stop()
        for fut in futs:
            with pytest.raises(mod.errors.ConnectError):
                fut.result()
        assert time.monotonic() - t0 < 5.0
    finally:
        gate.set()
        conn.close()
        teacher.stop()


def test_dynamic_teachers_follow_discovery():
    """The port's ``set_dynamic_teacher`` against the JAX package's
    in-process store, ``TeacherRegister`` and ``DiscoveryServer``, with
    the port's teachers: one teacher, then a second added, then the
    first removed; every epoch delivers every batch once, in order."""
    def gen():
        for i in range(16):
            yield (np.full((4, 2), i, np.float32),)

    with EmbeddedStore() as store:
        coord = store.client(root="torch_dynamic")
        teachers = [_echo_teacher(PKGS["torch"], 2.0) for _ in range(2)]
        regs = []
        disc = DiscoveryServer(coord, host="127.0.0.1").start()
        dr = _reader(PKGS["torch"], max_in_flight=4)
        try:
            regs.append(TeacherRegister(coord, "svc_t",
                                        teachers[0].endpoint,
                                        ttl=1).start())
            # a probe client makes the server watch the service, so the
            # student's first register finds the teacher (not NO_READY)
            assert _wait(lambda: disc.register_client(
                "probe", "svc_t", 1)["code"] == "OK")
            disc.unregister_client("probe", "svc_t")
            dr.set_batch_generator(gen)
            dr.set_dynamic_teacher(disc.endpoint, "svc_t", require_num=2)
            assert isinstance(dr._discover, t_discovery.DiscoveryClient)
            assert dr._discover.wait_for_servers(timeout=10) == [
                teachers[0].endpoint]

            def epoch():
                seen = []
                for img, soft in dr():
                    assert soft.tobytes() == (img * np.float32(2)).tobytes()
                    seen.append(int(img[0, 0]))
                assert seen == list(range(16))

            epoch()
            regs.append(TeacherRegister(coord, "svc_t",
                                        teachers[1].endpoint,
                                        ttl=1).start())
            both = sorted(t.endpoint for t in teachers)
            assert _wait(lambda: sorted(dr._discover.get_servers()) == both,
                         timeout=10)
            # the manage loop starts a worker for it within a second
            assert _wait(lambda: teachers[1].endpoint in dr._workers)
            epoch()
            assert teachers[1].stats()["batches"] > 0  # the reader followed
            regs[0].stop()
            teachers[0].stop()
            # the worker of the stopped teacher fails over at once; the
            # discovery update follows within a heartbeat
            epoch()
            assert _wait(lambda: dr._discover.get_servers() == [
                teachers[1].endpoint], timeout=10)
        finally:
            dr.stop()
            for r in regs:
                r.stop()
            for t in teachers:
                t.stop()
            disc.stop()
