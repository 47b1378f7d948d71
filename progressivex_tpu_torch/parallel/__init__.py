"""Scene and hypothesis parallelism over a mesh of torch devices."""
