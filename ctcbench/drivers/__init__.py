"""One driver per traffic kind, named by the ``kind`` of a traffic mix."""
