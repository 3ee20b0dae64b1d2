"""Messages of detzero_tpu/protos/waymo_dataset.proto (proto2, package
detzero_waymo): the subset of the public Waymo `Frame` that preprocessing
reads (range images, laser calibrations, poses, 3D labels).  Field numbers
and enum values are the .proto's; `Label.Box` has length = 4, width = 5
here, where waymo_label.proto has width = 4, length = 5 (which of the two
matches the public label.proto is open)."""

from detzero_tpu_torch.protos.wire import EnumType, Field, Message


class MatrixShape(Message):
    FIELDS = (Field(1, "dims", "int32", repeated=True),)


class MatrixFloat(Message):
    FIELDS = (Field(1, "data", "float", repeated=True, packed=True),
              Field(2, "shape", "message", message_type=MatrixShape))


class Transform(Message):
    FIELDS = (Field(1, "transform", "double", repeated=True),)   # 4x4


class Label(Message):
    class Box(Message):
        FIELDS = (Field(1, "center_x", "double"),
                  Field(2, "center_y", "double"),
                  Field(3, "center_z", "double"),
                  Field(4, "length", "double"),
                  Field(5, "width", "double"),
                  Field(6, "height", "double"),
                  Field(7, "heading", "double"))

    Type = EnumType("Type", TYPE_UNKNOWN=0, TYPE_VEHICLE=1,
                    TYPE_PEDESTRIAN=2, TYPE_SIGN=3, TYPE_CYCLIST=4)
    DifficultyLevel = EnumType("DifficultyLevel", UNKNOWN=0, LEVEL_1=1,
                               LEVEL_2=2)
    FIELDS = (Field(1, "box", "message", message_type=Box),
              Field(3, "type", "enum"),
              Field(4, "id", "string"),
              Field(5, "detection_difficulty_level", "enum"),
              Field(6, "tracking_difficulty_level", "enum"),
              Field(7, "num_lidar_points_in_box", "int32"))


class LaserName(Message):
    Name = EnumType("Name", UNKNOWN=0, TOP=1, FRONT=2, SIDE_LEFT=3,
                    SIDE_RIGHT=4, REAR=5)


class RangeImage(Message):
    # zlib-compressed MatrixFloat, (H, W, 4): range, intensity, elongation,
    # is_in_no_label_zone
    FIELDS = (Field(1, "range_image_compressed", "bytes"),
              Field(2, "camera_projection_compressed", "bytes"),
              Field(3, "range_image_pose_compressed", "bytes"))


class Laser(Message):
    FIELDS = (Field(1, "name", "enum"),
              Field(2, "ri_return1", "message", message_type=RangeImage),
              Field(3, "ri_return2", "message", message_type=RangeImage))


class LaserCalibration(Message):
    FIELDS = (Field(1, "name", "enum"),
              Field(2, "beam_inclinations", "double", repeated=True),
              Field(3, "beam_inclination_min", "double"),
              Field(4, "beam_inclination_max", "double"),
              Field(5, "extrinsic", "message", message_type=Transform))


class Context(Message):
    FIELDS = (Field(1, "name", "string"),
              Field(3, "laser_calibrations", "message", repeated=True,
                    message_type=LaserCalibration))


class Frame(Message):
    FIELDS = (Field(1, "context", "message", message_type=Context),
              Field(2, "timestamp_micros", "int64"),
              Field(3, "pose", "message", message_type=Transform),
              Field(5, "lasers", "message", repeated=True,
                    message_type=Laser),
              Field(6, "laser_labels", "message", repeated=True,
                    message_type=Label))
