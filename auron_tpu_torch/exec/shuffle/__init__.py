"""File shuffle: partitioning, the v2 block format, writer and reader."""
