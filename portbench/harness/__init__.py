"""The benchmark's machinery: cells by name, inputs from the seed, the
measured window, traces and their reduction, peaks, and the check."""
