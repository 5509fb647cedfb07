"""Restricts (search-time filtering) and crowding (result diversity);
counterpart of ``scann_tpu/restricts``.

Every filter lowers to a device mask: an [N] bool array that the searchers
with an ``allow_mask`` apply on the card, so disallowed rows never reach
the top-k; the others over-fetch and filter on the host. Crowding is a
host pass over the (short) sorted result lists.
"""


from scann_tpu_torch.restricts.filters import (
    RestrictFilter,
    NoRestrict,
    PredicateFilter,
    RangeFilter,
    AndFilter,
    OrFilter,
    NotFilter,
    AllowlistFilter,
    DenylistFilter,
)
from scann_tpu_torch.restricts.allowlist import (
    RestrictAllowlist,
    RestrictDenylist,
    RestrictTokenMap,
    SparseAllowlist,
)
from scann_tpu_torch.restricts.crowding import (
    CrowdingConfig,
    CrowdingConstraint,
    CrowdingMultidimensional,
    apply_crowding,
)

__all__ = [
    "RestrictFilter",
    "NoRestrict",
    "PredicateFilter",
    "RangeFilter",
    "AndFilter",
    "OrFilter",
    "NotFilter",
    "AllowlistFilter",
    "DenylistFilter",
    "RestrictAllowlist",
    "RestrictDenylist",
    "RestrictTokenMap",
    "SparseAllowlist",
    "CrowdingConfig",
    "CrowdingConstraint",
    "CrowdingMultidimensional",
    "apply_crowding",
]
