"""Host utilities of the port (``video``)."""
