"""Input pipelines of the port: the synthetic, randomly addressable token
stream."""
