"""The benchmark's general machinery: finding a cell's files by name,
the scenes and weights made from the seed, spans, the profiler's
reduction, the window and the result line."""
