"""Document-id table (counterpart of ``scann_tpu/data/docid.py``).

A host-side ordered collection with reverse lookup. Docids are strings or
ints; the device tensors hold dense datapoint indices only, and this table
translates them at the API boundary.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Union

from scann_tpu_torch.errors import ScannError

DocId = Union[str, int]


class DocIdCollection:
    """Ordered docids with O(1) reverse lookup."""

    def __init__(self, docids: Optional[Iterable[DocId]] = None):
        self._ids: List[DocId] = []
        self._reverse: Dict[DocId, int] = {}
        if docids is not None:
            for d in docids:
                self.add(d)

    def __len__(self) -> int:
        return len(self._ids)

    def __iter__(self):
        return iter(self._ids)

    def add(self, docid: DocId) -> int:
        """Append ``docid``; its index. A docid already present raises
        ``ALREADY_EXISTS``."""
        if docid in self._reverse:
            raise ScannError.already_exists(
                f"docid {docid!r} already present")
        idx = len(self._ids)
        self._ids.append(docid)
        self._reverse[docid] = idx
        return idx

    def get(self, index: int) -> DocId:
        """The docid at ``index``; ``OUT_OF_RANGE`` past the end."""
        if not 0 <= index < len(self._ids):
            raise ScannError.out_of_range(
                f"index {index} out of range [0, {len(self._ids)})")
        return self._ids[index]

    def index_of(self, docid: DocId) -> Optional[int]:
        return self._reverse.get(docid)

    def contains(self, docid: DocId) -> bool:
        return docid in self._reverse

    def to_list(self) -> List[DocId]:
        return list(self._ids)
