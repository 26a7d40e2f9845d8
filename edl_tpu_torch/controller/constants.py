"""Coordination-store service names and timing constants.

Reference parity: edl/utils/constants.py:15-27 (service names, TTL=15s).
Keys live under /<job_id>/<service>/nodes/<server> — job_id is the client
root, so jobs are fully namespace-isolated.
"""

SERVICE_RESOURCE = "resource"
SERVICE_LEADER = "leader"
SERVICE_CLUSTER = "cluster"
SERVICE_POD_STATUS = "pod_status"
SERVICE_JOB_STATUS = "job_status"
SERVICE_TRAIN_STATUS = "train_status"
SERVICE_READER = "reader"
SERVICE_STATE = "state"
SERVICE_JOB_FLAG = "job_flag"
SERVICE_METRICS = "metrics"
# leader HealthMonitor's health_report/v1 verdict doc (obs/health.py)
SERVICE_HEALTH = "health"
# peer-served restore plane: each trainer's StateServer endpoint +
# published snapshot version (edl_tpu/runtime/state_server.py)
SERVICE_STATE_SERVER = "state_server"
# zero-downtime live resize: the leader's two-phase intent, per-pod
# acks, and the trainers' live-capability keys
# (edl_tpu/runtime/live_resize.py)
SERVICE_LIVE_RESIZE = "live_resize"
# goodput autopilot's action/v1 journal and filed postmortem bundles
# (edl_tpu/obs/autopilot.py)
SERVICE_AUTOPILOT = "autopilot"
# watch-relay fan-out tree: each pod's WatchRelay advertises its
# endpoint here under a TTL lease; children resolve ancestors from
# this registry and fall through to direct store long-polls when no
# relay is advertised (edl_tpu/coordination/relay.py — the value is
# inlined there to keep coordination below controller; drift-guarded
# by tests/test_relay.py)
SERVICE_RELAY = "relay"
# diskless fault tolerance: each StateServer accepting erasure-coded
# partner checkpoint shards advertises here under a TTL lease; the
# pusher's partner ring and the rebuild's holder set are both
# resolved from this registry (edl_tpu/runtime/redundancy.py)
SERVICE_REDUNDANCY = "redundancy"

LEADER_SERVER = "0"          # the single leader key
CLUSTER_SERVER = "cluster"   # the single cluster-map key
JOB_STATUS_SERVER = "job_status"

import os

ETCD_TTL = int(os.environ.get("EDL_TPU_TTL", "10"))  # registration lease TTL
REFRESH_INTERVAL = ETCD_TTL / 3.0
GENERATE_INTERVAL = 1.0      # leader cluster-generator period
WATCH_INTERVAL = 1.0         # cluster watcher poll period
SUPERVISE_INTERVAL = 1.0     # launcher supervision loop period
BARRIER_TIMEOUT = int(os.environ.get("EDL_TPU_BARRIER_TIMEOUT", "600"))
RESIZE_BARRIER_TIMEOUT = int(
    os.environ.get("EDL_TPU_RESIZE_BARRIER_TIMEOUT", "120"))
FLAG_WAIT_TIMEOUT = int(os.environ.get("EDL_TPU_FLAG_WAIT_TIMEOUT", "300"))
# trainers exiting with this code were PREEMPTED after an emergency
# checkpoint (liveft restart convention) — not failed; the launcher
# awaits the membership change and respawns in place if none comes
PREEMPT_EXIT_CODE = 101
PREEMPT_RESPAWN_WAIT = float(
    os.environ.get("EDL_TPU_PREEMPT_RESPAWN_WAIT", "20"))
