"""Checksummed checkpoints of nested tensor/array trees
(``checkpoint.manager``)."""
