"""Training: the restorers' train steps (``common``) and their trainers
(``loops``)."""
