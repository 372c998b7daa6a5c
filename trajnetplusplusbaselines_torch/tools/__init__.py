"""Dataset tools of the port, copied from ``trajnetplusplusbaselines_tpu.tools``
as far as they are ported: ``get_dest``."""
