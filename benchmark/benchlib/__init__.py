"""The benchmark's own library: finding a cell's files, the seeded inputs,
the window arithmetic, the reduction of a profiler trace and the checks
around a run.  It imports nothing of the program at module level."""
