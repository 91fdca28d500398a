"""Runtime configuration (reference: crates/loro-internal/src/configure.rs)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class Configure:
    record_timestamp: bool = False
    merge_interval_s: int = 1000  # change RLE-merge window (reference default 1000s)
    editable_detached_mode: bool = False
    hide_empty_root_containers: bool = False
    # style expand behavior per key: "after" (default), "before", "both", "none"
    text_style_config: Dict[str, str] = field(default_factory=dict)
    # expand behavior for keys absent from text_style_config
    # (reference: LoroDoc::config_default_text_style)
    default_text_style: str = "after"
    # tree sibling positions: fractional indexes on create/move
    # (reference: Tree::enable/disable_fractional_index)
    fractional_index_enabled: bool = True
    fractional_index_jitter: int = 0
