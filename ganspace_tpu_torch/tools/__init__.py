"""Host tools of the port (``lightbox``, ``makesample``, ``upconv_split``)."""
