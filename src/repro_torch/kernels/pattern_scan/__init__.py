"""Multi-byte pattern scan over ragged batches of byte buffers."""
from .ops import (
    count_matches,
    find_pattern_mask,
    find_pattern_mask_batch,
    find_pattern_mask_rowgroup,
    find_pattern_masks_multi,
    find_pattern_masks_multi_rowgroup,
    find_pattern_positions,
)
from .pattern_scan import (DEFAULT_BLOCK, MAX_PATTERN, pattern_scan_batch,
                           pattern_scan_batch_multi, pattern_scan_multi_plain,
                           pattern_scan_plain, pattern_scan_rowgroup,
                           pattern_scan_rowgroup_multi,
                           pattern_scan_rowgroup_multi_plain,
                           pattern_scan_rowgroup_plain)
from .ref import pattern_mask_ref

__all__ = ["DEFAULT_BLOCK", "MAX_PATTERN", "count_matches",
           "find_pattern_mask", "find_pattern_mask_batch",
           "find_pattern_mask_rowgroup", "find_pattern_masks_multi",
           "find_pattern_masks_multi_rowgroup", "find_pattern_positions",
           "pattern_mask_ref", "pattern_scan_batch",
           "pattern_scan_batch_multi", "pattern_scan_multi_plain",
           "pattern_scan_plain", "pattern_scan_rowgroup",
           "pattern_scan_rowgroup_multi",
           "pattern_scan_rowgroup_multi_plain",
           "pattern_scan_rowgroup_plain"]
