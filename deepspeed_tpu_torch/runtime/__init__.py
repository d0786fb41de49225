"""Training runtime of the port: config, precision, lr schedules, the
single-process engine and the dataloader."""
