"""The benchmark's run machinery: spec, window, trace."""
