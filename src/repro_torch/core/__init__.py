"""Core structures of the port: params, hashing, matrices, pools, the sketch."""
