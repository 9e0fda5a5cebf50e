from .branch import BranchJoin, BroadcastSender
from .channel import AsyncReceiver, AsyncSender, ChannelError
from .framed import (K_BYTES, K_END, K_TENSOR, K_TENSOR_SEQ, TensorClient,
                     TensorServer, configure_socket, recv_frame, send_end,
                     send_frame)
from .replay import ACK_EVERY, ReplayBuffer, ReplayFanOut
from .replicate import FanInMerge, FanOutSender
from .staging import HostStagingRing

__all__ = ["BranchJoin", "BroadcastSender", "AsyncReceiver", "AsyncSender", "ChannelError", "K_BYTES",
           "K_END", "K_TENSOR", "K_TENSOR_SEQ", "TensorClient",
           "TensorServer", "configure_socket", "recv_frame", "send_end",
           "send_frame", "ACK_EVERY", "ReplayBuffer", "ReplayFanOut",
           "FanInMerge", "FanOutSender", "HostStagingRing"]
