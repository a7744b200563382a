"""Scripts of the port: ``kbench`` (the traversal kernel micro-bench) and
``standin`` (the procedural scenes they and ``chip_smoke.py`` render)."""
