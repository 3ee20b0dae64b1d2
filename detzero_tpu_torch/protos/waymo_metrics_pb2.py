"""Messages of detzero_tpu/protos/waymo_metrics.proto (proto2): `Object`
and `Objects`, the payload of a Waymo submission .bin."""

from detzero_tpu_torch.protos.waymo_label_pb2 import Label
from detzero_tpu_torch.protos.wire import Field, Message


class Object(Message):
    FIELDS = (Field(1, "object", "message", message_type=Label),
              Field(2, "score", "float"),
              Field(3, "frame_timestamp_micros", "int64"),
              Field(4, "context_name", "string"),
              Field(5, "overlap_with_nlz", "float"))


class Objects(Message):
    FIELDS = (Field(1, "objects", "message", repeated=True,
                    message_type=Object),)
