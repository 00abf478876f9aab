"""Training: the judge's and the restorers' train steps (``common``) and
their trainers (``loops``)."""
