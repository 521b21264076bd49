"""The benchmark's own modules: what every cell shares (the manifest, the
traffic generator, the trace reader, the FLOP and byte counters, the
device record, the comparison that decides ``correct``). Nothing here
imports the port; ``benchmark/families/`` holds what drives it."""
