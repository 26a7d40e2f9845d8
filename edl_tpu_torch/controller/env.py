"""Job-side and trainer-side environment contracts.

Reference parity: edl/utils/env.py — JobEnv (:107, nodes_range "min:max"
:76-87, device discovery :22-30) and TrainerEnv (:179). GPU discovery via
CUDA_VISIBLE_DEVICES becomes TPU chip discovery: EDL_TPU_DEVICES if set,
else one entry per local chip reported by the runtime, else [0].
"""

import os

from edl_tpu_torch.utils.network import get_host_ip


def _parse_nodes_range(s):
    if s is None:
        return 1, 1
    if ":" in s:
        lo, hi = s.split(":")
        lo, hi = int(lo), int(hi)
    else:
        lo = hi = int(s)
    if lo < 1 or hi < lo:
        raise ValueError("bad nodes_range %r" % s)
    return lo, hi


def _discover_devices():
    env = os.environ.get("EDL_TPU_DEVICES")
    if env is not None:
        return [int(x) for x in env.split(",") if x != ""]
    n = os.environ.get("EDL_TPU_NUM_DEVICES")
    if n is not None:
        return list(range(int(n)))
    return [0]


class JobEnv(object):
    def __init__(self, args=None):
        a = args or type("A", (), {})()

        def pick(attr, env_key, default=None):
            v = getattr(a, attr, None)
            if v is None:
                v = os.environ.get(env_key, default)
            return v

        self.job_id = pick("job_id", "EDL_TPU_JOB_ID")
        if not self.job_id:
            raise ValueError("job_id required (--job_id / EDL_TPU_JOB_ID)")
        endpoints = pick("store_endpoints", "EDL_TPU_STORE_ENDPOINTS",
                         "127.0.0.1:2379")
        self.store_endpoints = [e for e in str(endpoints).split(",") if e]
        self.min_nodes, self.max_nodes = _parse_nodes_range(
            pick("nodes_range", "EDL_TPU_NODES_RANGE", "1"))
        self.nproc_per_node = int(
            pick("nproc_per_node", "EDL_TPU_NPROC_PER_NODE", "1"))
        self.pod_ip = pick("pod_ip", "EDL_TPU_POD_IP", get_host_ip())
        self.devices = _discover_devices()
        self.checkpoint_path = pick("checkpoint_path",
                                    "EDL_TPU_CHECKPOINT_PATH", "")
        self.log_dir = pick("log_dir", "EDL_TPU_LOG_DIR", "./edl_tpu_logs")
        self.log_level = pick("log_level", "EDL_TPU_LOG_LEVEL", "INFO")


class TrainerEnv(object):
    """Read back the contract written by train_process.start_trainers."""

    def __init__(self, environ=None):
        e = environ or os.environ
        self.job_id = e.get("EDL_TPU_JOB_ID")
        self.store_endpoints = [
            x for x in e.get("EDL_TPU_STORE_ENDPOINTS", "").split(",") if x]
        self.pod_id = e.get("EDL_TPU_POD_ID")
        self.pod_rank = int(e.get("EDL_TPU_POD_RANK", "0"))
        self.trainer_id = e.get("EDL_TPU_TRAINER_ID")
        self.rank_in_pod = int(e.get("EDL_TPU_RANK_IN_POD", "0"))
        self.global_rank = int(e.get("EDL_TPU_GLOBAL_RANK", "0"))
        self.world_size = int(e.get("EDL_TPU_WORLD_SIZE", "1"))
        self.coordinator = e.get("EDL_TPU_COORDINATOR")
        self.trainer_endpoints = [
            x for x in e.get("EDL_TPU_TRAINER_ENDPOINTS", "").split(",") if x]
        self.endpoint = e.get("EDL_TPU_TRAINER_ENDPOINT")
        self.local_devices = [
            int(x) for x in e.get("EDL_TPU_LOCAL_DEVICES", "").split(",")
            if x != ""]
        self.cluster_stage = e.get("EDL_TPU_CLUSTER_STAGE")
        self.checkpoint_path = e.get("EDL_TPU_CHECKPOINT_PATH", "")
        # the generator's planned mesh factorization ({axis: size}),
        # None when no planner ran — training scripts pass it to
        # make_mesh so a restart lands on the scored factorization
        self.mesh = None
        raw = e.get("EDL_TPU_MESH")
        if raw:
            try:
                import json
                self.mesh = {str(k): int(v)
                             for k, v in json.loads(raw).items()}
            except (ValueError, TypeError, AttributeError):
                self.mesh = None

    @property
    def is_rank0(self):
        return self.global_rank == 0

    @property
    def under_launcher(self):
        return self.job_id is not None and self.trainer_id is not None
