"""SQL type system and its torch physical mapping.

Copied from ``auron_tpu/types.py`` (logical types, Spark rules) with the
physical mapping onto torch dtypes instead of jnp dtypes, and the Arrow
conversions made lazy (pyarrow is imported only inside them):

- fixed-width types map 1:1 onto dense torch tensors + a bool validity mask;
- DECIMAL(p<=18) is a scaled int64 ("decimal64"); DECIMAL(19..38), STRING,
  BINARY and the nested kinds are dictionary-encoded: int32 codes on the
  device, the vocabulary a numpy object array on the host. A wide
  decimal's vocabulary holds ``decimal.Decimal`` values at the column's
  scale (what ``pa.Array.to_pylist`` gives for the JAX package's
  Decimal128 dictionaries);
- DATE is int32 days since epoch, TIMESTAMP int64 microseconds;
- a LIST column's vocabulary holds one Python list per entry (the values
  Arrow's ``to_pylist`` gives), a NULL element as None; a MAP entry is a
  list of ``(key, value)`` pairs and a STRUCT entry a dict, as there.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np
import torch


class TypeKind(enum.Enum):
    NULL = "null"
    BOOL = "bool"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    DECIMAL = "decimal"
    DATE32 = "date32"
    TIMESTAMP = "timestamp"  # microseconds
    STRING = "string"
    BINARY = "binary"
    LIST = "list"
    MAP = "map"
    STRUCT = "struct"
    UNSUPPORTED = "unsupported"


_INT_KINDS = (TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.INT64)
_FLOAT_KINDS = (TypeKind.FLOAT32, TypeKind.FLOAT64)

_TORCH_OF_KIND = {
    TypeKind.BOOL: torch.bool,
    TypeKind.INT8: torch.int8,
    TypeKind.INT16: torch.int16,
    TypeKind.INT32: torch.int32,
    TypeKind.DATE32: torch.int32,
    TypeKind.INT64: torch.int64,
    TypeKind.TIMESTAMP: torch.int64,
    TypeKind.FLOAT32: torch.float32,
    TypeKind.FLOAT64: torch.float64,
    TypeKind.NULL: torch.int8,
}


@dataclass(frozen=True)
class DataType:
    """A logical SQL data type. Hashable."""

    kind: TypeKind
    precision: int = 0  # DECIMAL only
    scale: int = 0  # DECIMAL only
    inner: tuple = ()  # LIST: (element,); MAP: (key, value); STRUCT: field types
    struct_names: tuple = ()

    def __post_init__(self):
        if self.kind == TypeKind.DECIMAL:
            if not (1 <= self.precision <= 38):
                raise ValueError(f"bad decimal precision {self.precision}")

    @property
    def is_integer(self) -> bool:
        return self.kind in _INT_KINDS

    @property
    def is_float(self) -> bool:
        return self.kind in _FLOAT_KINDS

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_float or self.kind == TypeKind.DECIMAL

    @property
    def is_string_like(self) -> bool:
        return self.kind in (TypeKind.STRING, TypeKind.BINARY)

    @property
    def is_wide_decimal(self) -> bool:
        return self.kind == TypeKind.DECIMAL and self.precision > 18

    @property
    def is_nested(self) -> bool:
        return self.kind in (TypeKind.LIST, TypeKind.MAP, TypeKind.STRUCT)

    @property
    def is_dict_encoded(self) -> bool:
        return self.is_string_like or self.is_wide_decimal or self.is_nested

    def physical_dtype(self) -> torch.dtype:
        """torch dtype of the device value tensor for this logical type."""
        if self.is_dict_encoded:
            return torch.int32
        if self.kind == TypeKind.DECIMAL:
            return torch.int64
        if self.kind in _TORCH_OF_KIND:
            return _TORCH_OF_KIND[self.kind]
        raise TypeError(f"no physical dtype for {self}")

    def numpy_dtype(self) -> np.dtype:
        return np.dtype(str(self.physical_dtype()).replace("torch.", ""))

    def to_arrow(self):
        import pyarrow as pa

        k = self.kind
        m = {
            TypeKind.NULL: pa.null(), TypeKind.BOOL: pa.bool_(),
            TypeKind.INT8: pa.int8(), TypeKind.INT16: pa.int16(),
            TypeKind.INT32: pa.int32(), TypeKind.INT64: pa.int64(),
            TypeKind.FLOAT32: pa.float32(), TypeKind.FLOAT64: pa.float64(),
            TypeKind.DATE32: pa.date32(), TypeKind.TIMESTAMP: pa.timestamp("us"),
            TypeKind.STRING: pa.string(), TypeKind.BINARY: pa.binary(),
        }
        if k == TypeKind.DECIMAL:
            return pa.decimal128(self.precision, self.scale)
        if k == TypeKind.LIST:
            return pa.list_(self.inner[0].to_arrow())
        if k == TypeKind.MAP:
            return pa.map_(self.inner[0].to_arrow(), self.inner[1].to_arrow())
        if k == TypeKind.STRUCT:
            return pa.struct(
                [pa.field(n, t.to_arrow()) for n, t in zip(self.struct_names, self.inner)]
            )
        if k in m:
            return m[k]
        raise TypeError(f"no arrow type for {self}")

    @staticmethod
    def from_arrow(t) -> "DataType":
        import pyarrow as pa

        if pa.types.is_null(t):
            return NULL
        if pa.types.is_boolean(t):
            return BOOL
        if pa.types.is_int8(t):
            return INT8
        if pa.types.is_int16(t) or pa.types.is_uint8(t):
            return INT16
        if pa.types.is_int32(t) or pa.types.is_uint16(t):
            return INT32
        if pa.types.is_int64(t) or pa.types.is_uint32(t) or pa.types.is_uint64(t):
            return INT64
        if pa.types.is_float32(t):
            return FLOAT32
        if pa.types.is_float64(t):
            return FLOAT64
        if pa.types.is_decimal(t):
            return decimal(t.precision, t.scale)
        if pa.types.is_date32(t) or pa.types.is_date64(t):
            return DATE32
        if pa.types.is_timestamp(t):
            return TIMESTAMP
        if pa.types.is_string(t) or pa.types.is_large_string(t):
            return STRING
        if pa.types.is_binary(t) or pa.types.is_large_binary(t):
            return BINARY
        if isinstance(t, pa.DictionaryType):
            return DataType.from_arrow(t.value_type)
        if pa.types.is_list(t) or pa.types.is_large_list(t):
            return DataType(TypeKind.LIST, inner=(DataType.from_arrow(t.value_type),))
        if pa.types.is_map(t):
            return DataType(
                TypeKind.MAP,
                inner=(DataType.from_arrow(t.key_type), DataType.from_arrow(t.item_type)),
            )
        if pa.types.is_struct(t):
            return DataType(
                TypeKind.STRUCT,
                inner=tuple(DataType.from_arrow(t.field(i).type) for i in range(t.num_fields)),
                struct_names=tuple(t.field(i).name for i in range(t.num_fields)),
            )
        raise TypeError(f"unsupported arrow type {t}")

    def __repr__(self) -> str:
        if self.kind == TypeKind.DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        return self.kind.value


NULL = DataType(TypeKind.NULL)
BOOL = DataType(TypeKind.BOOL)
INT8 = DataType(TypeKind.INT8)
INT16 = DataType(TypeKind.INT16)
INT32 = DataType(TypeKind.INT32)
INT64 = DataType(TypeKind.INT64)
FLOAT32 = DataType(TypeKind.FLOAT32)
FLOAT64 = DataType(TypeKind.FLOAT64)
DATE32 = DataType(TypeKind.DATE32)
TIMESTAMP = DataType(TypeKind.TIMESTAMP)
STRING = DataType(TypeKind.STRING)
BINARY = DataType(TypeKind.BINARY)


def decimal(precision: int, scale: int) -> DataType:
    return DataType(TypeKind.DECIMAL, precision, scale)


def unscaled_int(value, scale: int) -> int:
    """Exact unscaled integer of a Decimal at the given scale (reference
    ``types.py:241``). Never ``Decimal.scaleb``: it rounds at the context's
    precision (28 digits by default) and corrupts decimal(38,x) values."""
    sign, digits, exp = value.as_tuple()
    u = int("".join(map(str, digits)))
    shift = exp + scale
    if shift >= 0:
        u *= 10**shift
    else:
        q, r = divmod(u, 10 ** (-shift))
        if r:
            raise ValueError(f"{value} does not fit scale {scale}")
        u = q
    return -u if sign else u


def decimal_from_unscaled(u: int, scale: int):
    """Exact Decimal of an unscaled integer (string construction is the one
    context-independent path)."""
    import decimal as pydec

    return pydec.Decimal(f"{int(u)}E-{scale}")


def decimal_at_scale(value, scale: int):
    """``value`` (a Decimal, int or str) as the Decimal a decimal(p, scale)
    column holds: exponent -scale, as Arrow's decimal128 values read back."""
    import decimal as pydec

    if not isinstance(value, pydec.Decimal):
        value = pydec.Decimal(str(value))
    return decimal_from_unscaled(unscaled_int(value, scale), scale)


#: Spark's default decimal for literals and sums
DECIMAL_SYSTEM_DEFAULT = decimal(38, 18)


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True


@dataclass(frozen=True)
class Schema:
    """A named, ordered list of fields. Hashable."""

    fields: tuple[Field, ...] = field(default_factory=tuple)

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, i: int) -> Field:
        return self.fields[i]

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    @staticmethod
    def of(*fields: Field) -> "Schema":
        return Schema(tuple(fields))

    def rename(self, names: list[str]) -> "Schema":
        assert len(names) == len(self.fields)
        return Schema(tuple(Field(n, f.dtype, f.nullable) for n, f in zip(names, self.fields)))

    def to_arrow(self):
        import pyarrow as pa

        return pa.schema(
            [pa.field(f.name, f.dtype.to_arrow(), nullable=f.nullable) for f in self.fields]
        )

    @staticmethod
    def from_arrow(s) -> "Schema":
        return Schema(
            tuple(Field(f.name, DataType.from_arrow(f.type), f.nullable) for f in s)
        )
