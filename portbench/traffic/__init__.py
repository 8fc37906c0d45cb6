"""Traffic: the inputs each cell hands to the port and to the reference,
made from the run's seed."""
