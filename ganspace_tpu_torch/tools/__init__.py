"""Tools of the port: ``lightbox``, ``makesample``, ``upconv_split``,
``ganseg``, ``allunitsample``, and the fit profilers ``profile_wpca`` and
``profile_convtap`` (their shared parts in ``profiling``)."""
