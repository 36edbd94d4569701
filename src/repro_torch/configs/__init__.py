"""The paper's own workload configs (:mod:`.deepmapping_paper`).

The reference's ``repro.configs`` package also registers the LM
architectures of its training substrate (``base.py`` and ten arch
modules, imported for their side effect).  Those belong to the LM
substrate, which the port has not taken yet (ROADMAP item M12), so this
package registers none.
"""
