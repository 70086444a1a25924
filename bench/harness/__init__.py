"""The benchmark's general machinery: the manifest, the traffic
generator, spans, the device trace and its reduction, peaks, results."""
