"""The protocol-buffer wire format and small proto2 message classes, with
no dependency on `google.protobuf`.

A message class lists its fields as `Field`s; an instance offers the
surface of protoc's generated Python classes that this package uses:
attribute get and set (an unset optional field reads its default), lazily
made nested messages, repeated fields with `.add()` (messages) or
`.extend()` (scalars), `len()`, indexing and iteration, `HasField`,
`ParseFromString`, `MergeFromString` and `SerializeToString`.

Serialization writes what protobuf's own Python library writes, byte for
byte: fields in field-number order; under proto2 an optional field that
was set is written even when it holds its default, and an unset one is
not; a nested message is set once anything under it was set (an
`.extend([])` included), while reading it sets nothing; repeated scalars
are unpacked unless the field is declared `[packed = true]`.

Parsing accepts packed and unpacked encodings of every repeated scalar
(writers differ) and skips fields the class does not declare, or that
arrive with a wire type the field cannot take.  Repeated numeric fields
are held as numpy arrays, so a packed float payload of a range image
decodes with one `np.frombuffer`.
"""

from __future__ import annotations

import struct

import numpy as np

VARINT, I64, LEN, SGROUP, EGROUP, I32 = 0, 1, 2, 3, 4, 5

# kind -> (wire type, numpy dtype of a repeated field or None)
KINDS = {
    "double": (I64, np.dtype("<f8")),
    "float": (I32, np.dtype("<f4")),
    "int32": (VARINT, np.dtype(np.int64)),
    "int64": (VARINT, np.dtype(np.int64)),
    "enum": (VARINT, np.dtype(np.int64)),
    "string": (LEN, None),
    "bytes": (LEN, None),
    "message": (LEN, None),
}
_DEFAULTS = {"double": 0.0, "float": 0.0, "int32": 0, "int64": 0, "enum": 0,
             "string": "", "bytes": b""}
_MASK64 = (1 << 64) - 1


def encode_varint(value: int) -> bytes:
    """Base-128 varint; a negative value as its 64-bit two's complement
    (ten bytes), as protobuf writes negative int32, int64 and enums."""
    value &= _MASK64
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_varint(buf, pos: int):
    """(value, next position) of the varint at `pos` (unsigned)."""
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than 10 bytes")


def _signed(value: int, bits: int) -> int:
    value &= (1 << bits) - 1
    return value - (1 << bits) if value >> (bits - 1) else value


def tag(number: int, wire_type: int) -> bytes:
    return encode_varint((number << 3) | wire_type)


def skip_field(buf, pos: int, wire_type: int, number: int) -> int:
    """The position after the value of a field of `wire_type` at `pos`."""
    if wire_type == VARINT:
        return decode_varint(buf, pos)[1]
    if wire_type == I64:
        pos += 8
    elif wire_type == I32:
        pos += 4
    elif wire_type == LEN:
        n, pos = decode_varint(buf, pos)
        pos += n
    elif wire_type == SGROUP:
        while True:
            key, pos = decode_varint(buf, pos)
            if key & 7 == EGROUP:
                if key >> 3 != number:
                    raise ValueError("mismatched end of group")
                return pos
            pos = skip_field(buf, pos, key & 7, key >> 3)
    else:
        raise ValueError(f"wire type {wire_type} cannot start a field")
    if pos > len(buf):
        raise ValueError("truncated field")
    return pos


class Field:
    """One declared field: its number, name, kind (a key of KINDS), whether
    it repeats, whether a repeated scalar is written packed, and for a
    message field the message class."""

    __slots__ = ("number", "name", "kind", "repeated", "packed",
                 "message_type", "wire_type", "dtype", "tag")

    def __init__(self, number, name, kind, repeated=False, packed=False,
                 message_type=None):
        self.number, self.name, self.kind = number, name, kind
        self.repeated, self.packed = repeated, packed
        self.message_type = message_type
        self.wire_type, self.dtype = KINDS[kind]
        self.tag = tag(number, LEN if packed else self.wire_type)


def _coerce(field, value):
    """A scalar as protobuf's Python classes hold it: floats rounded to
    float32 for `float`, ints checked, strings as str, bytes as bytes."""
    k = field.kind
    if k == "float":
        return float(np.float32(value))
    if k == "double":
        return float(value)
    if k in ("int32", "int64", "enum"):
        if isinstance(value, (float, np.floating)):
            raise TypeError(f"{field.name}: an integer field takes no float")
        value = int(value)
        lo = -(1 << 31) if k != "int64" else -(1 << 63)
        if not lo <= value < -lo:
            raise ValueError(f"{field.name}: {value} out of range")
        return value
    if k == "string":
        if isinstance(value, bytes):
            value = value.decode("utf-8")
        if not isinstance(value, str):
            raise TypeError(f"{field.name}: a string field takes str")
        return value
    if not isinstance(value, (bytes, bytearray, memoryview)):
        raise TypeError(f"{field.name}: a bytes field takes bytes")
    return bytes(value)


def _encode_scalar(kind, value) -> bytes:
    if kind == "double":
        return struct.pack("<d", value)
    if kind == "float":
        return struct.pack("<f", value)
    if kind in ("string", "bytes"):
        raw = value.encode("utf-8") if kind == "string" else value
        return encode_varint(len(raw)) + raw
    return encode_varint(int(value))


def _decode_scalar(field, buf, pos):
    k = field.kind
    if k == "double":
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if k == "float":
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if k in ("string", "bytes"):
        n, pos = decode_varint(buf, pos)
        if pos + n > len(buf):
            raise ValueError("truncated string or bytes field")
        raw = bytes(buf[pos:pos + n])
        return (raw.decode("utf-8") if k == "string" else raw), pos + n
    v, pos = decode_varint(buf, pos)
    if k == "int32" or k == "enum":
        return _signed(v, 32), pos      # sign-extended int32 on the wire
    return _signed(v, 64), pos


class RepeatedScalar:
    """A repeated scalar field: a numpy array for numeric kinds (kept as
    chunks until read), a list for strings and bytes.  Iteration and
    indexing give Python scalars, as protobuf's containers do."""

    __slots__ = ("_owner", "_field", "_chunks")

    def __init__(self, owner, field):
        self._owner, self._field = owner, field
        self._chunks = []

    def _array(self):
        dtype = self._field.dtype
        if dtype is None:
            return [v for c in self._chunks for v in c]
        if len(self._chunks) != 1 or isinstance(self._chunks[0], list):
            self._chunks = [np.concatenate(
                [np.asarray(c, dtype) for c in self._chunks])
                if self._chunks else np.zeros(0, dtype)]
        return self._chunks[0]

    def _add(self, values):
        f = self._field
        if f.dtype is None:
            self._chunks.append([_coerce(f, v) for v in values])
            return
        if f.kind in ("int32", "int64", "enum"):
            values = [_coerce(f, v) for v in np.asarray(values).tolist()] \
                if np.ndim(values) else [_coerce(f, values)]
        arr = np.asarray(values, f.dtype).reshape(-1)
        if len(arr):
            self._chunks.append(arr.copy())

    def extend(self, values):
        self._add(values if isinstance(values, np.ndarray) else list(values))
        self._owner._modified()

    def __len__(self):
        return sum(len(c) for c in self._chunks)

    def __iter__(self):
        a = self._array()
        return iter(a if isinstance(a, list) else a.tolist())

    def __getitem__(self, i):
        a = self._array()
        if isinstance(a, list):
            return a[i]
        v = a[i]
        return v.tolist()

    def __array__(self, dtype=None, copy=None):
        a = self._array()
        return np.asarray(a, dtype) if dtype is not None else np.asarray(a)

    def __repr__(self):
        return repr(list(self))

    def _encode(self) -> bytes:
        f = self._field
        if not len(self):
            return b""
        a = self._array()
        if f.packed:
            if f.kind in ("double", "float"):
                payload = a.astype(f.dtype, copy=False).tobytes()
            else:
                payload = b"".join(encode_varint(int(v)) for v in a.tolist())
            return f.tag + encode_varint(len(payload)) + payload
        vals = a if isinstance(a, list) else a.tolist()
        return b"".join(f.tag + _encode_scalar(f.kind, v) for v in vals)


class RepeatedMessage:
    """A repeated message field: `.add()` appends a new element."""

    __slots__ = ("_owner", "_field", "_items")

    def __init__(self, owner, field):
        self._owner, self._field = owner, field
        self._items = []

    def add(self):
        m = self._field.message_type()
        self._items.append(m)
        self._owner._modified()
        return m

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def _encode(self) -> bytes:
        out = []
        for m in self._items:
            raw = m.SerializeToString()
            out.append(self._field.tag + encode_varint(len(raw)) + raw)
        return b"".join(out)


class EnumType:
    """A proto enum: its values as attributes, `Name(number)` and
    `Value(name)`."""

    def __init__(self, name, **values):
        self._name = name
        self._values = dict(values)
        for k, v in values.items():
            setattr(self, k, v)

    def Name(self, number):
        for k, v in self._values.items():
            if v == number:
                return k
        raise ValueError(f"enum {self._name} has no value {number}")

    def Value(self, name):
        return self._values[name]

    def items(self):
        return list(self._values.items())


class Message:
    """Base of the message classes: subclasses set FIELDS, a tuple of
    Field; an EnumType among the class attributes also puts its values on
    the class, as protoc does (`Label.TYPE_VEHICLE`)."""

    FIELDS = ()
    __slots__ = ("_values", "_present", "_parent", "_pfield")

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._BY_NAME = {f.name: f for f in cls.FIELDS}
        cls._BY_NUMBER = {f.number: f for f in cls.FIELDS}
        cls._ORDER = tuple(sorted(cls.FIELDS, key=lambda f: f.number))
        for v in list(vars(cls).values()):
            if isinstance(v, EnumType):
                for k, n in v.items():
                    setattr(cls, k, n)

    def __init__(self):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_present", set())
        object.__setattr__(self, "_parent", None)
        object.__setattr__(self, "_pfield", None)

    def _field(self, name):
        f = self._BY_NAME.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field "
                                 f"{name!r}")
        return f

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        f = self._field(name)
        vals = self._values
        if name in vals:
            return vals[name]
        if f.repeated:
            v = (RepeatedMessage if f.kind == "message"
                 else RepeatedScalar)(self, f)
        elif f.kind == "message":
            v = f.message_type()
            object.__setattr__(v, "_parent", self)
            object.__setattr__(v, "_pfield", name)
        else:
            return _DEFAULTS[f.kind]
        vals[name] = v
        return v

    def __setattr__(self, name, value):
        f = self._field(name)
        if f.repeated or f.kind == "message":
            raise AttributeError(f"assignment to the {'repeated' if f.repeated else 'message'} "
                                 f"field {name!r} is not allowed")
        self._values[name] = _coerce(f, value)
        self._present.add(name)
        self._modified()

    def _modified(self):
        """Marks this message present in its parent, and so on up."""
        m = self
        while m._parent is not None and m._pfield not in m._parent._present:
            m._parent._present.add(m._pfield)
            m = m._parent

    def HasField(self, name):
        f = self._field(name)
        if f.repeated:
            raise ValueError(f"{name!r} is repeated: use len()")
        return name in self._present

    def Clear(self):
        self._values.clear()
        self._present.clear()

    def SerializeToString(self) -> bytes:
        out = []
        vals, present = self._values, self._present
        for f in self._ORDER:
            name = f.name
            if f.repeated:
                if name in vals:
                    out.append(vals[name]._encode())
            elif name in present:
                v = vals[name]
                if f.kind == "message":
                    raw = v.SerializeToString()
                    out.append(f.tag + encode_varint(len(raw)) + raw)
                else:
                    out.append(f.tag + _encode_scalar(f.kind, v))
        return b"".join(out)

    def ParseFromString(self, data) -> int:
        self.Clear()
        return self.MergeFromString(data)

    def MergeFromString(self, data) -> int:
        buf = data if isinstance(data, (bytes, bytearray)) else bytes(data)
        self._merge(buf, 0, len(buf))
        self._modified()
        return len(buf)

    def _merge(self, buf, pos, end):
        by_number, vals = self._BY_NUMBER, self._values
        while pos < end:
            key, pos = decode_varint(buf, pos)
            number, wt = key >> 3, key & 7
            f = by_number.get(number)
            if f is None or (wt != f.wire_type and not (
                    f.repeated and wt == LEN and f.dtype is not None)):
                pos = skip_field(buf, pos, wt, number)
                continue
            if f.kind == "message":
                n, pos = decode_varint(buf, pos)
                if pos + n > end:
                    raise ValueError(f"{f.name}: truncated message")
                if f.repeated:
                    cont = getattr(self, f.name)
                    m = f.message_type()
                    cont._items.append(m)
                else:
                    m = getattr(self, f.name)
                    self._present.add(f.name)
                m._merge(buf, pos, pos + n)
                pos += n
            elif f.repeated:
                cont = getattr(self, f.name)
                if wt == LEN and f.dtype is not None:       # packed
                    n, pos = decode_varint(buf, pos)
                    stop = pos + n
                    if stop > end:
                        raise ValueError(f"{f.name}: truncated packed field")
                    if f.kind in ("double", "float"):
                        cont._chunks.append(np.frombuffer(
                            buf, f.dtype, n // f.dtype.itemsize, pos).copy())
                        pos = stop
                    else:
                        items = []
                        while pos < stop:
                            v, pos = _decode_scalar(f, buf, pos)
                            items.append(v)
                        cont._chunks.append(np.asarray(items, f.dtype))
                else:       # one element; runs of them gather in a list
                    v, pos = _decode_scalar(f, buf, pos)
                    if cont._chunks and isinstance(cont._chunks[-1], list):
                        cont._chunks[-1].append(v)
                    else:
                        cont._chunks.append([v])
            else:
                vals[f.name], pos = _decode_scalar(f, buf, pos)
                self._present.add(f.name)
            if pos > end:
                raise ValueError(f"{f.name}: field runs past its message")

    def __repr__(self):
        return f"{type(self).__name__}({self.SerializeToString()!r})"
