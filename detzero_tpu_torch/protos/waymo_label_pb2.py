"""Messages of detzero_tpu/protos/waymo_label.proto (proto2): the fields of
the public `Label` that a submission fills.  `Label.Box` has width = 4,
length = 5 here, the reverse of waymo_dataset.proto (open: see
waymo_dataset_pb2)."""

from detzero_tpu_torch.protos.wire import EnumType, Field, Message


class Label(Message):
    class Box(Message):
        FIELDS = (Field(1, "center_x", "double"),
                  Field(2, "center_y", "double"),
                  Field(3, "center_z", "double"),
                  Field(4, "width", "double"),
                  Field(5, "length", "double"),
                  Field(6, "height", "double"),
                  Field(7, "heading", "double"))

    class Metadata(Message):
        FIELDS = (Field(1, "speed_x", "double"),
                  Field(2, "speed_y", "double"),
                  Field(3, "accel_x", "double"),
                  Field(4, "accel_y", "double"))

    Type = EnumType("Type", TYPE_UNKNOWN=0, TYPE_VEHICLE=1,
                    TYPE_PEDESTRIAN=2, TYPE_SIGN=3, TYPE_CYCLIST=4)
    FIELDS = (Field(1, "box", "message", message_type=Box),
              Field(2, "metadata", "message", message_type=Metadata),
              Field(3, "type", "enum"),
              Field(4, "id", "string"),
              Field(5, "num_lidar_points_in_box", "int32"))
