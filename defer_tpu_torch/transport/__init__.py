from .channel import AsyncReceiver, AsyncSender, ChannelError
from .framed import (K_BYTES, K_END, K_TENSOR, K_TENSOR_SEQ, TensorClient,
                     TensorServer, configure_socket, recv_frame, send_end,
                     send_frame)
from .replay import ReplayBuffer
from .staging import HostStagingRing

__all__ = ["AsyncReceiver", "AsyncSender", "ChannelError", "K_BYTES",
           "K_END", "K_TENSOR", "K_TENSOR_SEQ", "TensorClient",
           "TensorServer", "configure_socket", "recv_frame", "send_end",
           "send_frame", "ReplayBuffer", "HostStagingRing"]
