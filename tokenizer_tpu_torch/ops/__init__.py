"""Device kernels of the port: the packed merge and its pair-table probe."""
