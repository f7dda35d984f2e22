"""The paper's figure scripts on the port (counterparts of ``notebooks/``).

    python -m ganspace_tpu_torch.notebooks.run_all [--tiny] [--device cpu]
    python -m ganspace_tpu_torch.notebooks.figure_teaser --tiny --device cpu

Each ``figure_*`` module has a ``main(argv)`` that writes its PNG into
``$GANSPACE_FIGURE_DIR`` (default ``out/figures``) or ``--outdir`` and
returns its path; ``notebook_init`` holds the shared setup.
``make_demo_notebook`` builds (and with ``--execute`` runs) the demo
notebook ``Ganspace_torch.ipynb``.
"""
