# -*- coding: utf-8 -*-
# Stateless device (JAX/Pallas) numeric kernels — the analog of the
# reference's NumPy/SciPy algorithm backends (SURVEY.md L4).
