"""Robinhood Policy Engine core, ported slice by slice.

Slice 1 carries the policy run: catalog -> compiled predicate programs ->
match (``policy_scan`` kernels) -> plan -> act. Slice 2 carries the
``rbh-report`` analytics: the profile cube (built by the ``profile_cube``
kernel when opted in), the scalar stats oracle, grants and reports.
"""
from .types import (AGE_PROFILE_EDGES, AGE_PROFILE_LABELS, ChangelogRecord,
                    ChangelogType, Entry, FsType, HsmState,
                    SIZE_PROFILE_EDGES, SIZE_PROFILE_LABELS,
                    age_profile_bucket, format_size, parse_duration,
                    parse_size, size_profile_bucket)
from .catalog import Catalog, CatalogShard, ColumnBatch, StringTable
from .changelog import ChangelogHub, ChangelogStream, ColumnarRecords
from .fidtable import FidTable
from .grants import GrantTable, Subject
from .policy import (ALWAYS, And, Cmp, Const, Expr, Not, Or, PolicyError,
                     compile_program, compile_programs, parse_expr,
                     KERNEL_COLUMNS)
from .policy_engine import (EVALUATORS, PolicyDefinition, PolicyEngine, Rule,
                            RunReport, UsageWatermarkTrigger)
from .profiles import GroupIndex, ProfileCube
from .stats import ChangelogCounters, DirUsage, StatsAggregator
from .telemetry import (Counter, Gauge, Histogram, MetricRegistry, Span,
                        parse_prometheus)
from .reports import Reports

__all__ = [
    "AGE_PROFILE_EDGES", "AGE_PROFILE_LABELS", "ChangelogRecord",
    "ChangelogType", "Entry", "FsType", "HsmState",
    "SIZE_PROFILE_EDGES", "SIZE_PROFILE_LABELS",
    "age_profile_bucket", "format_size", "parse_duration", "parse_size",
    "size_profile_bucket",
    "Catalog", "CatalogShard", "ColumnBatch", "StringTable",
    "ChangelogHub", "ChangelogStream", "ColumnarRecords",
    "FidTable",
    "GrantTable", "Subject",
    "GroupIndex", "ProfileCube",
    "ALWAYS", "And", "Cmp", "Const", "Expr", "Not", "Or", "PolicyError",
    "compile_program", "compile_programs", "parse_expr", "KERNEL_COLUMNS",
    "EVALUATORS", "PolicyDefinition", "PolicyEngine", "Rule", "RunReport",
    "UsageWatermarkTrigger",
    "ChangelogCounters", "DirUsage", "StatsAggregator",
    "Counter", "Gauge", "Histogram", "MetricRegistry", "Span",
    "parse_prometheus",
    "Reports",
]
