"""Robinhood Policy Engine core, ported slice by slice.

This slice carries the policy run: catalog -> compiled predicate programs
-> match (``policy_scan`` kernels) -> plan -> act.
"""
from .types import (AGE_PROFILE_EDGES, AGE_PROFILE_LABELS, ChangelogRecord,
                    ChangelogType, Entry, FsType, HsmState,
                    SIZE_PROFILE_EDGES, SIZE_PROFILE_LABELS,
                    age_profile_bucket, format_size, parse_duration,
                    parse_size, size_profile_bucket)
from .catalog import Catalog, CatalogShard, ColumnBatch, StringTable
from .changelog import ChangelogHub, ChangelogStream, ColumnarRecords
from .fidtable import FidTable
from .policy import (ALWAYS, And, Cmp, Const, Expr, Not, Or, PolicyError,
                     compile_program, compile_programs, parse_expr,
                     KERNEL_COLUMNS)
from .policy_engine import (EVALUATORS, PolicyDefinition, PolicyEngine, Rule,
                            RunReport, UsageWatermarkTrigger)
from .telemetry import (Counter, Gauge, Histogram, MetricRegistry, Span,
                        parse_prometheus)

__all__ = [
    "AGE_PROFILE_EDGES", "AGE_PROFILE_LABELS", "ChangelogRecord",
    "ChangelogType", "Entry", "FsType", "HsmState",
    "SIZE_PROFILE_EDGES", "SIZE_PROFILE_LABELS",
    "age_profile_bucket", "format_size", "parse_duration", "parse_size",
    "size_profile_bucket",
    "Catalog", "CatalogShard", "ColumnBatch", "StringTable",
    "ChangelogHub", "ChangelogStream", "ColumnarRecords",
    "FidTable",
    "ALWAYS", "And", "Cmp", "Const", "Expr", "Not", "Or", "PolicyError",
    "compile_program", "compile_programs", "parse_expr", "KERNEL_COLUMNS",
    "EVALUATORS", "PolicyDefinition", "PolicyEngine", "Rule", "RunReport",
    "UsageWatermarkTrigger",
    "Counter", "Gauge", "Histogram", "MetricRegistry", "Span",
    "parse_prometheus",
]
