"""The fleet base: ``DistributedStrategy`` and the role makers."""
