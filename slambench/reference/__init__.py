"""The plain reference (``plain``), the replay of a job's steps from its
frames (``events``) and the comparison that decides ``correct``
(``check``)."""
