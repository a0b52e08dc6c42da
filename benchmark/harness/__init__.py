"""The benchmark's general code: the manifest and the files it names, the
card and import guards, the measured window, the trace's reduction."""
