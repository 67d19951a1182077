"""The native engine of the snapshot clones and the bind commit path: a C
extension (``fastmodel.c``) built with gcc at first use by
:mod:`.build`. Its entries stand beside the Python bodies they equal,
behind the switches ``apiserver.store.ObjectStore.NATIVE_PUBLISH``,
``cache.cache.SchedulerCache.NATIVE_APPLY`` and ``.NATIVE_ECHO``,
``trace.ledger.NATIVE_CONFIRM`` and ``models.job_info.NATIVE_CLONE``; all
are on by default."""
