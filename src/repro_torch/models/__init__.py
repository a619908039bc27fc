"""Model configuration, layers and the paged serving steps."""
