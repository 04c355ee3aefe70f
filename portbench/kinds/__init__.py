"""The runners of the traffic kinds: ``setup``, ``window``, ``verify``."""
