"""Launch layer: the production training launcher (``train``). The mesh,
dry-run and roofline modules are not ported yet (ROADMAP.md queue 1
item 12)."""
