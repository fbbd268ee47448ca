"""HTTP transport of the port's daemons."""
