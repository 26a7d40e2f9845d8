from edl_tpu_torch.rpc.server import RpcServer
from edl_tpu_torch.rpc.client import RpcClient, call

__all__ = ["RpcServer", "RpcClient", "call"]
