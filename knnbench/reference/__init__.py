"""Plain references that decide ``correct``.  Each module computes one
metric's exact k-NN rows with textbook methods (NumPy, plain PyTorch,
SciPy's LP solver) and imports nothing of the program.  Each exposes

``judge(index, queries, reported_ids, k, params, device)``
    -> (for each array of reported ids, the true distance of each id;
    the k smallest true distances of each row, sorted), float64 arrays
    (rows, k);
``control(index, queries, k, params, device)``
    -> (ids, distances): the reference put in the program's place in the
    configuration's lower precision, the control that has to fail.
"""
