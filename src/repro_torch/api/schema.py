"""Schema — the explicit attribute surface of an
:class:`~repro_torch.api.Index`.

A schema names the categorical (``tags``) and numeric (``nums``) metadata
fields an index stores. Numeric fields are positional: ``nums`` order is
the column order of the engine's ``(n, F)`` value matrix, so a compiled
``Num("price") < 50`` predicate carries ``(field_idx, lo, hi)`` straight
onto the device verification path.

Build either with an explicit schema::

    Index.build(vectors, metadata,
                schema=Schema(tags=["cat"], nums=["price", "year"]))

or let :meth:`Schema.infer` derive one from the metadata dicts (every
float-valued key becomes a numeric field, everything else a tag field).
Records must carry *every* numeric field (the value matrix is dense); tag
fields may be sparse.

Counterpart of ``repro.api.schema``, copied (the port imports nothing of
``repro``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


class UnknownFieldError(KeyError, ValueError):
    """A filter references a field the index schema does not contain.

    Raised at *compile* time (not at device dispatch) so typos surface
    before any engine work. Subclasses both ``KeyError`` (lookup flavor)
    and ``ValueError`` (pre-rename call sites caught the latter).
    """

    def __init__(self, kind: str, field: str, known: Sequence[str]):
        msg = (f"{kind} field {field!r} is not indexed "
               f"(schema {kind} fields: {sorted(known)!r})")
        super().__init__(msg)
        self.field = field

    def __str__(self) -> str:          # KeyError would repr()-quote the msg
        return self.args[0]


def _is_numeric_value(v) -> bool:
    import numpy as np
    return isinstance(v, (float, np.floating)) and not isinstance(v, bool)


@dataclasses.dataclass(frozen=True)
class Schema:
    """Declared attribute fields of an index.

    ``tags``: categorical fields (str/int/bool values, or lists thereof).
    ``nums``: numeric fields; order fixes the value-matrix columns.
    """
    tags: tuple = ()
    nums: tuple = ()

    def __post_init__(self):
        tags = tuple(dict.fromkeys(self.tags))      # dedupe, keep order
        nums = tuple(dict.fromkeys(self.nums))
        object.__setattr__(self, "tags", tags)
        object.__setattr__(self, "nums", nums)
        overlap = set(tags) & set(nums)
        if overlap:
            raise ValueError(f"fields {sorted(overlap)} declared both "
                             "tag and numeric")
        for f in tags + nums:
            if not isinstance(f, str):
                raise TypeError(f"field names must be str, got {f!r}")

    # -- lookups ---------------------------------------------------------
    @property
    def n_fields(self) -> int:
        """Numeric value-matrix width (≥1: indexes with no numeric field
        still carry one zero column so device shapes stay uniform)."""
        return max(1, len(self.nums))

    def num_index(self, field: str) -> int:
        """Column of ``field`` in the value matrix; UnknownFieldError if
        the schema does not declare it."""
        try:
            return self.nums.index(field)
        except ValueError:
            raise UnknownFieldError("numeric", field, self.nums) from None

    def check_tag(self, field: str) -> str:
        if field not in self.tags:
            raise UnknownFieldError("tag", field, self.tags)
        return field

    # -- construction ----------------------------------------------------
    @classmethod
    def infer(cls, metadata: Sequence[dict]) -> "Schema":
        """Derive a schema from metadata dicts: a field holding any float
        becomes numeric (plain ints are numeric-compatible, so mixed
        int/float columns stay numeric), everything else a tag field
        (names sorted for a deterministic column order). A field mixing
        floats with tag-only values (str/bool/lists) is ambiguous and
        needs an explicit Schema."""
        import numpy as np
        has_float, has_tag_only = set(), set()
        for d in metadata:
            for key, v in d.items():
                if _is_numeric_value(v):
                    has_float.add(key)
                elif not isinstance(v, (int, np.integer)) \
                        or isinstance(v, bool):
                    has_tag_only.add(key)     # str / bool / list / …
        clash = has_float & has_tag_only
        if clash:
            raise ValueError(
                f"fields {sorted(clash)} hold both float and tag values; "
                "pass an explicit Schema to disambiguate")
        tags = {k for d in metadata for k in d} - has_float
        return cls(tags=tuple(sorted(tags)), nums=tuple(sorted(has_float)))

    def to_json(self) -> dict:
        return {"tags": list(self.tags), "nums": list(self.nums)}

    @classmethod
    def from_json(cls, obj: dict) -> "Schema":
        return cls(tags=tuple(obj.get("tags", ())),
                   nums=tuple(obj.get("nums", ())))
