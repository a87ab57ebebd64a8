"""The benchmark's scenes, built in memory from the seed."""
