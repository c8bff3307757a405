"""Train and eval steps, loss, optimizer and schedule of the port."""
