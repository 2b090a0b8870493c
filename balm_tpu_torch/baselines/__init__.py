from . import balm1, ef, pa
