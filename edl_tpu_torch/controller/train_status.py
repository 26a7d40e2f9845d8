"""Training-progress status written by trainers, read by the generator.

Reference parity: edl/utils/train_status.py (INITIAL/RUNNING/NEARTHEEND/
SUCCEED/FAILED :21-26; the generator stops scaling out when training is
NEARTHEEND — doc/edl_collective_design_doc.md:27).
"""

from edl_tpu_torch.controller import constants


class TrainStatus(object):
    INITIAL = "INITIAL"
    RUNNING = "RUNNING"
    NEARTHEEND = "NEARTHEEND"
    SUCCEED = "SUCCEED"
    FAILED = "FAILED"


def save_train_status(coord, pod_id, status):
    coord.set_server_permanent(constants.SERVICE_TRAIN_STATUS, pod_id, status)


def load_train_status(coord, pod_id):
    return coord.get_value(constants.SERVICE_TRAIN_STATUS, pod_id)
