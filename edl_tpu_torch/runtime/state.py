"""Elastic training state: epoch/step bookkeeping, data checkpoint, and
resize-time adjustment hooks, persisted in the coordination store.

Reference parity: edl/utils/state.py — DataCheckpoint (:25-31), EpochAttr
(:34-39), TrainStatus epoch map + global step (:61-111), State with
register_adjust_function (:142) and leader-guarded store save (:186-200).
The model/optimizer tensors themselves go through
edl_tpu_torch.runtime.checkpoint; this is the small metadata the control plane
needs to reason about progress and resizes.
"""

from edl_tpu_torch.controller import constants
from edl_tpu_torch.utils.json_serializable import Serializable

STATE_SERVER = "state"


class DataCheckpoint(Serializable):
    """Which input files exist and which record ranges are consumed —
    enables data-aware resume without re-reading finished shards."""

    def __init__(self):
        self.file_list = []
        self.processed = {}  # file_name -> [[begin, end], ...]

    def mark_processed(self, file_name, begin, end):
        spans = self.processed.setdefault(file_name, [])
        spans.append([begin, end])
        spans.sort()
        merged = []
        for b, e in spans:
            if merged and b <= merged[-1][1] + 1:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([b, e])
        self.processed[file_name] = merged

    def is_processed(self, file_name, idx):
        return any(b <= idx <= e
                   for b, e in self.processed.get(file_name, []))


class EpochAttr(Serializable):
    def __init__(self):
        self.epoch_no = -1
        self.world_size = 0
        self.step_num = 0
        self.avg_step_time = 0.0
        self.ended = False


class State(Serializable):
    _json_types = {"data_checkpoint": DataCheckpoint}

    def __init__(self, total_batch_size=0, user_defined=None):
        self.total_batch_size = total_batch_size
        self.global_step = 0
        self.epoch_no = -1
        self.epochs = {}  # str(epoch_no) -> EpochAttr dict
        self.data_checkpoint = DataCheckpoint()
        self.user_defined = user_defined or {}
        self._adjust_fns = []  # not serialized (leading underscore skipped)

    # -- epochs --------------------------------------------------------------

    def begin_epoch(self, epoch_no, world_size):
        self.epoch_no = epoch_no
        attr = EpochAttr()
        attr.epoch_no = epoch_no
        attr.world_size = world_size
        self.epochs[str(epoch_no)] = attr.to_dict()

    def end_epoch(self, step_num, avg_step_time):
        attr = self.epochs.get(str(self.epoch_no), {})
        attr["step_num"] = step_num
        attr["avg_step_time"] = avg_step_time
        attr["ended"] = True
        self.epochs[str(self.epoch_no)] = attr

    def next_epoch(self):
        """The epoch a restart should run: the interrupted epoch itself
        when the newest checkpoint was written mid-epoch (emergency
        preemption save) — the epoch is re-run from its start so none of
        its data is skipped (already-consumed batches are replayed;
        exactly-once resume is the ElasticReader/data_checkpoint path) —
        else the one after the last completed epoch. Older checkpoints
        lack the ``ended`` flag but were only ever written at epoch end,
        so the compat default is True."""
        attr = self.epochs.get(str(self.epoch_no))
        if attr is not None and not attr.get("ended", True):
            return self.epoch_no
        return self.epoch_no + 1

    # -- resize hooks --------------------------------------------------------

    def register_adjust_function(self, fn):
        """fn(state, new_world_size) called when the world resizes —
        the hyperparameter re-adjustment hook of the reference
        (state.py:142; doc/edl_collective_design_doc.md:15-17)."""
        self._adjust_fns.append(fn)

    def adjust(self, new_world_size):
        for fn in self._adjust_fns:
            fn(self, new_world_size)

    def carry_hooks_to(self, other):
        """Transfer registered adjust hooks onto ``other`` (a State
        deserialized from a checkpoint — hooks are process-local and never
        serialized). Returns ``other``."""
        other._adjust_fns = list(self._adjust_fns)
        return other

    # -- serialization (skip private attrs) ----------------------------------

    def to_dict(self):
        return {k: (v.to_dict() if isinstance(v, Serializable) else v)
                for k, v in self.__dict__.items() if not k.startswith("_")}


def save_to_store(coord, state, leader_pod_id=None):
    """Persist; when ``leader_pod_id`` is given the write is guarded on that
    pod still holding leadership (reference state.py:186-200)."""
    value = state.to_json()
    if leader_pod_id is None:
        coord.set_server_permanent(constants.SERVICE_STATE, STATE_SERVER,
                                   value)
        return True
    key = coord.service_prefix(constants.SERVICE_STATE) + STATE_SERVER
    return coord.put_if_leader(constants.SERVICE_LEADER,
                               constants.LEADER_SERVER, leader_pod_id,
                               [(key, value)])


def load_from_store(coord):
    value = coord.get_value(constants.SERVICE_STATE, STATE_SERVER)
    if value is None:
        return None
    return State().from_json(value)
