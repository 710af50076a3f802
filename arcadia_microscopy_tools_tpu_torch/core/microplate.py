"""High-content-screening plate layouts.

Host-side bookkeeping for plate experiments: a `Well` knows its normalized
position ("a1" and "A01" are the same well) plus whatever sample annotations
the experimenter attached, and a `MicroplateLayout` is a validated collection
of wells with dict-style access, CSV round-trip, and a text grid renderer.
The plate runner (`parallel.plate`) schedules device work off `well_ids`.

API/behavior parity with the reference library's plate module
(`src/arcadia_microscopy_tools/microplate.py:10-251`), re-implemented here
around one shared `normalize_well_id` parser.
"""

from __future__ import annotations

import re
from collections.abc import Iterator, Sequence
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import pandas as pd

__all__ = ["Well", "MicroplateLayout", "normalize_well_id"]

# rows A-Z x columns 1-48 covers every SBS plate up to 3456 wells
_MAX_COLUMN = 48
_ID_PATTERN = re.compile(r"^([A-Za-z])(\d+)$")


def normalize_well_id(well_id: str) -> str:
    """Parse a well identifier and return its canonical "A01" form.

    Accepts any case and any zero padding ("a1", "A1", "A01" are all well
    A01). Raises ValueError for anything that is not one row letter followed
    by a column number within the plate bounds.
    """
    if not well_id or len(well_id) < 2:
        raise ValueError("Well ID must be at least 2 characters (e.g., 'A1' or 'A01')")

    match = _ID_PATTERN.match(well_id)
    if match is None:
        first = well_id[0].upper()
        if not first.isalpha() or not first.isascii():
            raise ValueError(f"Row must be A-Z, got '{first}'")
        raise ValueError(f"Could not parse column number from '{well_id}'")

    row_letter = match.group(1).upper()
    column = int(match.group(2))
    if not 1 <= column <= _MAX_COLUMN:
        raise ValueError(f"Column must be 1-{_MAX_COLUMN}, got {column}")
    return f"{row_letter}{column:02d}"


@dataclass(frozen=True)
class Well:
    """One plate well: canonical position plus sample annotations.

    Attributes:
        id: Position identifier; normalized to "A01" form on construction.
        sample: What was plated in this well (free text, "" if unannotated).
        properties: Any further experimenter-supplied key/value annotations
            (dose, timepoint, replicate, ...).
    """

    id: str  # canonical "A01"-form position
    sample: str = ""  # free-text sample annotation
    properties: dict[str, Any] = field(default_factory=dict)  # extra annotations

    def __post_init__(self) -> None:
        canonical = normalize_well_id(self.id)
        if canonical != self.id:
            object.__setattr__(self, "id", canonical)

    @property
    def row(self) -> str:
        """The row letter ("A" for well A01)."""
        return self.id[:1]

    @property
    def column(self) -> int:
        """The column number (1 for well A01)."""
        return int(self.id[1:], 10)

    def __str__(self) -> str:
        return self.id

    def __repr__(self) -> str:
        extras = f", properties={self.properties!r}" if self.properties else ""
        return f"Well(id='{self.id}', sample='{self.sample}'{extras})"

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> Well:
        """Build a Well from one CSV-style record.

        The record must carry a string under "well_id"; "sample" is optional
        and every remaining key lands in `properties`.
        """
        if "well_id" not in data:
            raise ValueError("Dictionary must contain 'well_id' key")  # CSV contract
        raw_id = data["well_id"]
        if not isinstance(raw_id, str):
            raise ValueError(f"well_id must be a string, got {type(raw_id).__name__}")

        annotations = {
            key: value for key, value in data.items() if key not in ("well_id", "sample")
        }
        return cls(raw_id, data.get("sample", ""), annotations)


@dataclass(frozen=True)
class MicroplateLayout:
    """A validated set of wells with dict-style lookup by (fuzzy) well ID.

    Construction rejects duplicate positions; lookups normalize their
    argument first, so `layout["a1"]` finds well A01.

    Args:
        wells: The Well objects making up the plate.
    """

    wells: Sequence[Well]  # as provided at construction
    _layout: dict[str, Well] = field(init=False, repr=False)  # canonical-id index

    def __post_init__(self) -> None:
        by_id: dict[str, Well] = {}
        for well in self.wells:
            if well.id in by_id:
                raise ValueError(f"Duplicate well ID: '{well.id}'")
            by_id[well.id] = well
        object.__setattr__(self, "_layout", by_id)

    @property
    def layout(self) -> dict[str, Well]:
        """Mapping from canonical well ID to Well."""
        return self._layout  # built once in __post_init__

    @property
    def rows(self) -> list[str]:
        """Sorted distinct row letters present on the plate."""
        return sorted({well.row for well in self._layout.values()})

    @property
    def columns(self) -> list[int]:
        """Sorted distinct column numbers present on the plate."""
        return sorted({well.column for well in self._layout.values()})

    @property
    def well_ids(self) -> list[str]:
        """All canonical well IDs, sorted."""
        return sorted(self._layout)

    def __getitem__(self, well_id: str) -> Well:
        try:
            canonical = normalize_well_id(well_id)
        except ValueError as e:
            raise KeyError(f"Invalid well ID '{well_id}': {e}") from None
        well = self._layout.get(canonical)
        if well is None:
            raise KeyError(f"Well ID '{well_id}' not found in plate layout.")
        return well

    def __len__(self) -> int:
        return len(self._layout)

    def __contains__(self, well_id: str) -> bool:
        try:
            return normalize_well_id(well_id) in self._layout
        except ValueError:
            return False

    def __iter__(self) -> Iterator[Well]:
        return iter(self._layout.values())

    @classmethod
    def from_csv(cls, csv_path: Path, **kwargs) -> MicroplateLayout:
        """Read a layout from a CSV with a `well_id` column.

        Extra columns become per-well `properties` (a "sample" column, if
        present, fills `Well.sample`). `**kwargs` pass through to
        `pd.read_csv`.
        """
        table = pd.read_csv(csv_path, **kwargs)
        if table.empty:
            raise ValueError(f"CSV file '{csv_path}' is empty")
        if "well_id" not in table.columns:
            raise ValueError(
                f"CSV file '{csv_path}' missing required 'well_id' column. "
                f"Found columns: {list(table.columns)}"
            )
        return cls([Well.from_dict(record) for record in table.to_dict("records")])

    def to_dataframe(self) -> pd.DataFrame:
        """One row per well: well_id, row, column, sample, plus properties."""
        if not self._layout:
            return pd.DataFrame()
        records = []
        for well in self._layout.values():
            record = dict(
                well_id=well.id, row=well.row, column=well.column, sample=well.sample
            )
            record.update(well.properties)
            records.append(record)
        return pd.DataFrame(records)

    def display(self) -> str:
        """Render the plate as a row x column sample grid ('-' = empty)."""
        table = self.to_dataframe()
        if table.empty:
            return "Empty plate layout"
        grid = table.pivot(index="row", columns="column", values="sample").fillna("-")
        return grid.to_string()
