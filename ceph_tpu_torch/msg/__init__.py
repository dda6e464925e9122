from .queue import (Envelope, MessageQueue, QueueClosed, QueueFull,
                    MSG_OSD_OP, MSG_OSD_OP_REPLY, MSG_EC_SUB_WRITE,
                    MSG_EC_SUB_WRITE_REPLY, MSG_EC_SUB_READ,
                    MSG_EC_SUB_READ_REPLY, MSG_PING)
from .dispatcher import BatchingDispatcher, ShardFanout

__all__ = ["Envelope", "MessageQueue", "QueueClosed", "QueueFull",
           "BatchingDispatcher", "ShardFanout",
           "MSG_OSD_OP", "MSG_OSD_OP_REPLY", "MSG_EC_SUB_WRITE",
           "MSG_EC_SUB_WRITE_REPLY", "MSG_EC_SUB_READ",
           "MSG_EC_SUB_READ_REPLY", "MSG_PING"]
