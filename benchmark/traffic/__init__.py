"""Traffic kinds: `benchmark.traffic.<kind>.run(ctx)` drives one cell's
mix (its `workloads/<cell>.json`) through the program."""
