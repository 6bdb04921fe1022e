"""Small shared helpers of the port: typed errors and device selection."""
