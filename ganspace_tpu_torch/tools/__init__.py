"""Host tools of the port (``lightbox``)."""
