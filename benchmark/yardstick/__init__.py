"""The benchmark's yardstick: the table of peaks, the operation counts, the
statistics, the reduction of a profiler trace to busy time, launches and
idle gaps, and the comparisons that decide ``correct``.  Later changes to
the port do not reach it."""
