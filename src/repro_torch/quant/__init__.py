"""Weight stores, wire codec and the EdgeArtifact of the PyTorch port."""
