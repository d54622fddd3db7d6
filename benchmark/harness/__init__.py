"""The benchmark's general parts: the manifest and the files it names, the
yardstick (peaks, bytes, operations), the profiler's reduction, the
comparisons that decide ``correct``, and the run of one cell."""
