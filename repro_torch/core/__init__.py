"""Host side of the port: formats, scheduler, packing, plan."""
